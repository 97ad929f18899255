"""The A3C dueling loss, vectorized over env rows.

Port of ``active_tracking_rl_tpu/ops/losses.py:dueling_loss``. Per row and
agent over a T-step rollout:
    value_loss  = sum_t 0.5 * (R_t - V_t)^2
    policy_loss = sum_t -(logpi_t * gae_t + w_ent * H_t)
with the tracker's entropy weight `entropy` and the target's
`entropy_target`. Mode 0 trains the tracker's loss, 1 the target's, other
modes both. Returns and GAE carry no gradient; V enters only through R - V.
With the TAT target's aux reward head,
    pred_loss   = sum_t |r_pred_t - r_t,tracker|
is added to the loss in every mode but 0 (and reported in all).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from active_tracking_rl_torch.ops.gae import gae_returns


class LossStats(NamedTuple):
    loss: torch.Tensor          # (B,)
    policy_loss: torch.Tensor   # (B, 2)
    value_loss: torch.Tensor    # (B, 2)
    entropy: torch.Tensor       # (B, 2) summed over T
    pred_loss: torch.Tensor     # (B,), zeros without an aux head


def dueling_loss(rewards: torch.Tensor,      # (T, B, 2)
                 values: torch.Tensor,       # (T, B, 2)
                 bootstrap: torch.Tensor,    # (B, 2) V(s_T)
                 log_probs: torch.Tensor,    # (T, B, 2)
                 entropies: torch.Tensor,    # (T, B, 2)
                 done: torch.Tensor,         # (T, B)
                 training_mode: int,
                 gamma: float, tau: float,
                 w_entropy: float, w_entropy_target: float,
                 r_preds: Optional[torch.Tensor] = None  # (T, B) aux head
                 ) -> LossStats:
    ret, gae = gae_returns(rewards, values.detach(), bootstrap.detach(), done,
                           gamma, tau)
    advantage = ret - values
    value_loss = (0.5 * advantage ** 2).sum(0)                        # (B, 2)
    w_ent = torch.tensor([w_entropy, w_entropy_target], dtype=rewards.dtype,
                         device=rewards.device)
    policy_loss = (-(log_probs * gae) - w_ent * entropies).sum(0)     # (B, 2)
    loss_tracker = policy_loss[:, 0] + 0.5 * value_loss[:, 0]
    loss_target = policy_loss[:, 1] + 0.5 * value_loss[:, 1]
    if training_mode == 0:
        loss = loss_tracker
    elif training_mode == 1:
        loss = loss_target
    else:
        loss = loss_tracker + loss_target
    if r_preds is None:
        pred_loss = torch.zeros_like(loss)
    else:
        pred_loss = (r_preds - rewards[..., 0]).abs().sum(0)
        if training_mode != 0:
            loss = loss + pred_loss
    return LossStats(loss, policy_loss, value_loss, entropies.sum(0),
                     pred_loss)
