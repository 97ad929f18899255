"""BFS distance fields for the scripted navigator.

Port of ``active_tracking_rl_tpu/envs/distance.py``.

* ``distance_fields`` is the iteration-capped relaxation, the oracle that the
  sweep kernels must equal bit for bit.
* ``distance_fields_sweep`` is the exact fast sweep (plain PyTorch, as the
  JAX one is plain XLA): no iteration cap, at most 64 rounds.
* ``distance_field`` and ``distance_field_sweep`` are the one-goal forms
  (JAX's own names), the goal axis of the two above.
* ``distance_fields_backend`` picks an implementation by the JAX package's
  backend names; the tensor's device then picks the CUDA kernel or its plain
  twin (``ops/flood.py``).

All take one maze (S, S) with goals (G, 2), or a batch (N, S, S) with
(N, G, 2), and return int16 fields (G, S, S) or (N, G, S, S).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from active_tracking_rl_torch.ops.flood import (INF, seed_fields,
                                                flood_fields,
                                                flood_fields_plain)

__all__ = ["INF", "BACKENDS", "distance_field", "distance_fields",
           "distance_field_sweep", "distance_fields_sweep",
           "distance_fields_backend"]

#: flood_backend name -> flood_fields variant of the kernels.
_KERNEL_VARIANT = {"auto": "sweep", "pallas_sweep": "sweep", "pallas": "relax"}
BACKENDS = (*_KERNEL_VARIANT, "xla", "sweep")


def _batched(fn, maze: torch.Tensor, goals: torch.Tensor, *args):
    goals = goals.to(torch.int32)
    if maze.dim() == 2:
        return fn(maze[None].contiguous(), goals[None].contiguous(), *args)[0]
    return fn(maze.contiguous(), goals.contiguous(), *args)


def distance_fields(maze: torch.Tensor, goals: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """Shortest 4-connected path lengths, INF beyond `iters` and at walls."""
    return _batched(flood_fields_plain, maze, goals, iters)


def distance_field(maze: torch.Tensor, goal: torch.Tensor,
                   iters: int) -> torch.Tensor:
    """One goal: (S, S) with (2,) -> (S, S), or (N, S, S) with (N, 2) ->
    (N, S, S); `distance_fields` with a goal axis of one."""
    return distance_fields(maze, goal.unsqueeze(-2), iters).squeeze(-3)


def _minplus_scan(c: torch.Tensor, k: torch.Tensor, dim: int,
                  reverse: bool) -> torch.Tensor:
    """Inclusive scan of f(x) = min(c, x + k) along `dim` (log-depth).

    Returns the composed c: min over j up to i of c_j + k_{j+1} + ... + k_i,
    sums saturated at INF, so nothing crosses a wall (k = INF there). The
    values are integers, so any association gives the JAX scan's result.
    """
    if reverse:
        return _minplus_scan(c.flip(dim), k.flip(dim), dim, False).flip(dim)
    n = c.shape[dim]
    lead = [0, 0] * (c.dim() - 1 - dim % c.dim())
    shift = 1
    while shift < n:
        # the element `shift` back, the identity (c = INF, k = 0) before 0
        ca = F.pad(c.narrow(dim, 0, n - shift), lead + [shift, 0], value=INF)
        ka = F.pad(k.narrow(dim, 0, n - shift), lead + [shift, 0], value=0)
        c = torch.minimum(c, torch.clamp_max(ca + k, INF))
        k = torch.clamp_max(ka + k, INF)
        shift *= 2
    return c


def distance_fields_sweep(maze: torch.Tensor, goals: torch.Tensor,
                          max_rounds: int = 64) -> torch.Tensor:
    """Exact BFS distance fields by fast sweeping, no iteration cap.

    A round sweeps both ways vertically from the same field and takes the
    min, then both ways horizontally. Each field stops after its first round
    that changes nothing, or after `max_rounds` rounds, as in the JAX
    package; a field that has stopped is a fixpoint, so the batch runs until
    every field has.
    """
    return _batched(_sweep_fields, maze, goals, max_rounds)


def distance_field_sweep(maze: torch.Tensor, goal: torch.Tensor,
                         max_rounds: int = 64) -> torch.Tensor:
    """One goal, as `distance_field`; `distance_fields_sweep` with a goal
    axis of one."""
    return distance_fields_sweep(maze, goal.unsqueeze(-2),
                                 max_rounds).squeeze(-3)


def _sweep_fields(maze: torch.Tensor, goals: torch.Tensor,
                  max_rounds: int) -> torch.Tensor:
    wall = (maze != 0)[:, None]
    k = torch.where(wall, INF, 1).to(torch.int32).expand(
        -1, goals.shape[1], -1, -1)
    d = seed_fields(wall, goals).to(torch.int32)

    def one_round(d):
        dv = torch.minimum(_minplus_scan(d, k, -2, False),
                           _minplus_scan(d, k, -2, True))
        d = torch.where(wall, INF, torch.minimum(d, dv))
        dh = torch.minimum(_minplus_scan(d, k, -1, False),
                           _minplus_scan(d, k, -1, True))
        return torch.where(wall, INF, torch.minimum(d, dh))

    prev, d = d, one_round(d)
    for _ in range(1, max_rounds):
        if torch.equal(d, prev):
            break
        prev, d = d, one_round(d)
    return d.to(torch.int16)


def distance_fields_backend(maze: torch.Tensor, goals: torch.Tensor,
                            iters: int, backend: str = "auto") -> torch.Tensor:
    """The fields through the implementation `backend` names.

    "auto" and "pallas_sweep": the fast-sweep kernel (CUDA) or its twin
    (CPU); "pallas": the relaxation kernel or its twin; "xla":
    ``distance_fields``; "sweep": ``distance_fields_sweep``. The last two run
    on the tensor's device. Any other name raises.
    """
    if backend in _KERNEL_VARIANT:
        return _batched(functools.partial(flood_fields,
                                          variant=_KERNEL_VARIANT[backend]),
                        maze, goals, iters)
    if backend == "xla":
        return distance_fields(maze, goals, iters)
    if backend == "sweep":
        return distance_fields_sweep(maze, goals)
    raise ValueError(f"unknown flood backend {backend!r}; "
                     f"expected one of {BACKENDS}")
