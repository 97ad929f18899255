"""Discrete action sampling.

Port of ``active_tracking_rl_tpu/models/heads.py`` (discrete heads; the value
and policy heads themselves are plain ``nn.Linear`` layers). Sampling
takes its Gumbel noise as a tensor: the sampled action is
argmax(logits + gumbel), which is what ``jax.random.categorical`` computes
from its key, so tests can feed JAX's noise. The gathers replace the JAX
package's one-hot lane selects. Continuous heads wait.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class ActionSample(NamedTuple):
    action: torch.Tensor      # (B,) int64
    entropy: torch.Tensor     # (B, 1)
    log_prob: torch.Tensor    # (B, 1)


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
