"""n-step returns and GAE as a reverse loop over time.

Port of ``active_tracking_rl_tpu/ops/gae.py``. Per agent, masked across
episode boundaries with (1 - done_t):
    R       = gamma * R * c_t + r_t
    delta_t = r_t + gamma * V_{t+1} * c_t - V_t
    gae     = gae * gamma * tau * c_t + delta_t
"""

from __future__ import annotations

from typing import Tuple

import torch


def gae_returns(rewards: torch.Tensor, values: torch.Tensor,
                bootstrap: torch.Tensor, done: torch.Tensor,
                gamma: float, tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """rewards, values (T, ...); bootstrap (...) = V(s_T); done (T, ...)
    broadcastable to rewards from the left. Returns (R, gae), both (T, ...)."""
    cont = 1.0 - done.to(rewards.dtype)
    cont = cont.reshape(cont.shape + (1,) * (rewards.dim() - cont.dim()))
    v_next = torch.cat([values[1:], bootstrap[None]], dim=0)
    r_acc, gae_acc = bootstrap, torch.zeros_like(bootstrap)
    ret, gae = [], []
    for t in reversed(range(rewards.shape[0])):
        r_t, c_t = rewards[t], cont[t]
        r_acc = gamma * r_acc * c_t + r_t
        delta = r_t + gamma * v_next[t] * c_t - values[t]
        gae_acc = gae_acc * gamma * tau * c_t + delta
        ret.append(r_acc)
        gae.append(gae_acc)
    return torch.stack(ret[::-1]), torch.stack(gae[::-1])
