"""Observations: egocentric crops (Partial) or the whole map (Full), with
the agents painted in.

Port of ``active_tracking_rl_tpu/envs/observe.py``. The maze is stored
pre-padded with ``pob_size`` wall cells, so agent i's (2p+1)^2 window starts
at its unpadded position. Crops and the centring roll are plain gathers (the
JAX package's one-hot matmuls were a TPU lowering workaround and are exact
only because the cells are small integers).
"""

from __future__ import annotations

import torch

from active_tracking_rl_torch.config import EnvConfig


def partial_obs(cfg: EnvConfig, maze_padded: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """(N, P, P) uint8 padded mazes, (N, 2, 2) positions -> (N, 2, w, w) uint8.

    The other agent is painted 2 + 2j where it lies inside the window (tracker
    2, target 4); the observer's own cell is painted last, so its colour wins
    on overlap.
    """
    w, p = cfg.pob_window, cfg.pob_size
    n, side = maze_padded.shape[0], maze_padded.shape[-1]
    ar = torch.arange(w, device=pos.device)
    pos = pos.long()
    r = pos[..., 0, None, None] + ar[:, None]             # (N, 2, w, 1)
    c = pos[..., 1, None, None] + ar[None, :]             # (N, 2, 1, w)
    flat = maze_padded.reshape(n, 1, side * side).expand(n, 2, side * side)
    crop = flat.gather(2, (r * side + c).reshape(n, 2, w * w))  # (N, 2, w*w)

    rel = pos.flip(1) - pos + p                           # other agent, (N, 2, 2)
    inside = ((rel >= 0) & (rel < w)).all(-1, keepdim=True)
    cell = (rel[..., 0] * w + rel[..., 1]).clamp(0, w * w - 1)[..., None]
    own = 2 + 2 * torch.arange(2, dtype=torch.uint8, device=pos.device)
    painted = torch.where(inside, own.flip(0).expand(n, 2)[..., None],
                          crop.gather(2, cell))
    crop = crop.scatter(2, cell, painted)
    crop[..., p * w + p] = own
    return crop.reshape(n, 2, w, w)


def full_obs(cfg: EnvConfig, maze_padded: torch.Tensor,
             pos: torch.Tensor) -> torch.Tensor:
    """(N, P, P) uint8 padded mazes, (N, 2, 2) positions -> (N, 2, S, S) uint8.

    Both agents see one painted map: the tracker's cell 2, then the target's
    cell 4 (so 4 wins on overlap), with no own-cell repaint. With
    `cfg.center_full_obs` each agent's copy is rolled cyclically so that the
    agent sits at the centre cell (S // 2, S // 2).
    """
    p, s = cfg.pob_size, cfg.maze_size
    n = maze_padded.shape[0]
    painted = maze_padded[:, p:p + s, p:p + s].reshape(n, s * s).clone()
    pos = pos.long()
    cells = pos[..., 0] * s + pos[..., 1]                 # (N, 2)
    painted.scatter_(1, cells[:, :1], 2)
    painted.scatter_(1, cells[:, 1:], 4)
    painted = painted.reshape(n, 1, s, s)
    if not cfg.center_full_obs:
        return painted.expand(n, 2, s, s).contiguous()
    ar = torch.arange(s, device=pos.device)
    rows = (ar + pos[..., 0, None] - s // 2) % s          # (N, 2, S)
    cols = (ar + pos[..., 1, None] - s // 2) % s
    b = torch.arange(n, device=pos.device)[:, None, None, None]
    return painted[b, 0, rows[..., :, None], cols[..., None, :]]


def observe(cfg: EnvConfig, maze_padded: torch.Tensor,
            pos: torch.Tensor) -> torch.Tensor:
    if cfg.obs_type == "Full":
        return full_obs(cfg, maze_padded, pos)
    return partial_obs(cfg, maze_padded, pos)
