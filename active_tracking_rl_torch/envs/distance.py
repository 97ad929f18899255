"""BFS distance fields for the scripted navigator.

``distance_fields`` is the iteration-capped relaxation, the oracle that every
flood implementation must equal bit for bit. ``distance_fields_backend``
dispatches by tensor device: the CUDA fast-sweep kernel for a CUDA tensor,
the plain twin for a CPU tensor (``ops/flood.py``).

Both take one maze (S, S) with goals (G, 2), or a batch (N, S, S) with
(N, G, 2), and return int16 fields (G, S, S) or (N, G, S, S).
"""

from __future__ import annotations

import torch

from active_tracking_rl_torch.ops.flood import INF, flood_fields, flood_fields_plain

__all__ = ["INF", "distance_fields", "distance_fields_backend"]


def _batched(fn, maze: torch.Tensor, goals: torch.Tensor, iters: int):
    if maze.dim() == 2:
        return fn(maze[None].contiguous(), goals[None].contiguous(), iters)[0]
    return fn(maze.contiguous(), goals.contiguous(), iters)


def distance_fields(maze: torch.Tensor, goals: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """Shortest 4-connected path lengths, INF beyond `iters` and at walls."""
    return _batched(flood_fields_plain, maze, goals.to(torch.int32), iters)


def distance_fields_backend(maze: torch.Tensor, goals: torch.Tensor,
                            iters: int) -> torch.Tensor:
    """Same fields through the device's implementation (kernel on CUDA)."""
    return _batched(flood_fields, maze, goals.to(torch.int32), iters)
