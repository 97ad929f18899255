"""Action sampling: discrete and continuous heads.

Port of ``active_tracking_rl_tpu/models/heads.py`` (the value and policy
heads themselves are plain ``nn.Linear`` layers in ``models/dueling.py``).
Sampling takes its noise as a tensor, so tests can feed JAX's draws:

* discrete: Gumbel noise; the sampled action is argmax(logits + gumbel),
  which is what ``jax.random.categorical`` computes from its key. The
  gathers replace the JAX package's one-hot lane selects.
* continuous: standard normal noise `eps`, the draw of
  ``jax.random.normal``. sigma = softplus(sigma_raw) + 1e-5 is a variance;
  the density and entropy are evaluated at the unclamped sample
  mu + sqrt(sigma) * eps, and only the env-facing action is clamped to
  [-1, 1].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class ActionSample(NamedTuple):
    action: torch.Tensor      # (B,) int64 | (B, A) float32 continuous (clamped)
    entropy: torch.Tensor     # (B, 1)     | (B, A)
    log_prob: torch.Tensor    # (B, 1)     | (B, A)
    #: continuous only: the unclamped sample, at which the density was
    #: evaluated; teacher-forced replay evaluates it again.
    raw_action: Optional[torch.Tensor] = None


def sample_discrete(logits: torch.Tensor, gumbel: Optional[torch.Tensor],
                    test: bool = False) -> ActionSample:
    """Softmax entropy; argmax(logits + gumbel) (train) or argmax p (test,
    which reads no noise); the log-probability of the chosen action."""
    log_p = torch.log_softmax(logits, dim=-1)
    p = torch.exp(log_p)
    entropy = -(log_p * p).sum(-1, keepdim=True)
    if test:
        action = torch.argmax(p, dim=-1)
    else:
        action = torch.argmax(logits.detach() + gumbel, dim=-1)
    return ActionSample(action, entropy, log_p.gather(-1, action[:, None]))


def eval_discrete(logits: torch.Tensor, action: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(entropy (B,1), log_prob (B,1)) of a given action under `logits`."""
    log_p = torch.log_softmax(logits, dim=-1)
    p = torch.exp(log_p)
    entropy = -(log_p * p).sum(-1, keepdim=True)
    return entropy, log_p.gather(-1, action.long()[:, None])


def _normal(mu: torch.Tensor, sigma_raw: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mu clipped to [-1, 1] and the variance softplus(sigma_raw) + 1e-5."""
    return torch.clamp(mu, -1.0, 1.0), F.softplus(sigma_raw) + 1e-5


def _density(mu: torch.Tensor, sigma: torch.Tensor, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(entropy, log(pdf(x) + 1e-6)) of N(mu, sigma), sigma a variance."""
    pdf = (torch.exp(-((x - mu) ** 2) / (2 * sigma))
           / torch.sqrt(2 * sigma * math.pi))
    entropy = 0.5 * (torch.log(2 * math.pi * sigma) + 1.0)
    return entropy, torch.log(pdf + 1e-6)


def sample_continuous(mu: torch.Tensor, sigma_raw: torch.Tensor,
                      eps: torch.Tensor, test: bool = False) -> ActionSample:
    """raw = mu + sqrt(sigma) * eps (no gradient through the sample), its
    entropy and log-density, and the action clamped to [-1, 1]. `test` is
    ignored, as in the JAX package: continuous evaluation samples too."""
    del test
    mu, sigma = _normal(mu, sigma_raw)
    raw = (mu + torch.sqrt(sigma) * eps).detach()
    entropy, log_prob = _density(mu, sigma, raw)
    return ActionSample(torch.clamp(raw, -1.0, 1.0), entropy, log_prob, raw)


def eval_continuous(mu: torch.Tensor, sigma_raw: torch.Tensor,
                    action: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(entropy, log_prob) of a given continuous action; `action` is the
    raw (unclamped) sample stored when acting."""
    return _density(*_normal(mu, sigma_raw), action)
