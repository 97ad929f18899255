"""Map generation (Block, Empty, Maze) and spawn sampling, batched over rows.

Port of ``active_tracking_rl_tpu/envs/maps.py``. Every function takes a
batch of N maps and its random draws as tensors (``MapDraws``,
``SpawnDraws``); ``draw_map`` and ``draw_spawns`` make them from a
``noise.Threefry``. Fed the draws that ``jax.random`` made, each function
returns the JAX package's result bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Optional, Tuple

import torch

from active_tracking_rl_torch.config import EnvConfig
from active_tracking_rl_torch.ops import noise

#: large finite "minus infinity" for masked Gumbel sampling.
_NEG = -1e9
#: goal resamples while a goal sits on the tracker spawn.
_SPAWN_RETRIES = 8


@dataclasses.dataclass
class MapDraws:
    #: (N,) float32 U[0,1): the obstacle ratio (Block) or the walk's
    #: complexity and density ratio (Maze), read at level 0 only.
    ratio_u: torch.Tensor
    #: Block/Empty: (N, (S-2)^2) int64 obstacle cell permutation.
    perm: Optional[torch.Tensor] = None
    #: Maze: (N, max_density, 2) int64 walk starts (row, col) in [0, S//2],
    #: in units of two cells.
    walk_start: Optional[torch.Tensor] = None
    #: Maze: (N, max_density, max_complexity, 3) int64; [..., m - 2] is the
    #: walk step's draw from [0, m) for m = 2, 3, 4 valid neighbours.
    walk_pick: Optional[torch.Tensor] = None


@dataclasses.dataclass
class SpawnDraws:
    tracker: torch.Tensor      # (N, S*S) float32 Gumbel: tracker cell
    goals: torch.Tensor        # (N, S*S) Gumbel: the two goals
    retry: torch.Tensor        # (N, 8, S*S) Gumbel: goal resamples
    target: torch.Tensor       # (N, S*S) Gumbel: target cell near the tracker


def draw_map(cfg: EnvConfig, n: int, generator: noise.Threefry, device,
             rows: Optional[Tuple[int, int]] = None) -> MapDraws:
    """The map draws of n rows (of rows lo..hi-1 with `rows`; the generator
    advances as for n)."""
    u = noise.uniform((n,), generator, device, rows=rows)
    if cfg.map_type == "Maze":
        max_complexity, max_density = maze_loop_bounds(cfg)
        half = cfg.maze_size // 2
        picks = noise.uniform((n, max_density, max_complexity, 1), generator,
                              device, rows=rows)
        m = torch.arange(2, 5, device=device)
        return MapDraws(
            ratio_u=u,
            walk_start=noise.randint(half + 1, (n, max_density, 2), generator,
                                     device, rows=rows),
            walk_pick=torch.floor(picks * m).long())
    interior = cfg.maze_size - 2
    return MapDraws(
        ratio_u=u,
        perm=noise.permutations(n, interior * interior, generator, device,
                                rows))


def draw_spawns(cfg: EnvConfig, n: int, generator: noise.Threefry, device,
                rows: Optional[Tuple[int, int]] = None) -> SpawnDraws:
    c = cfg.maze_size ** 2
    return SpawnDraws(
        tracker=noise.gumbel((n, c), generator, device, rows),
        goals=noise.gumbel((n, c), generator, device, rows),
        retry=noise.gumbel((n, _SPAWN_RETRIES, c), generator, device, rows),
        target=noise.gumbel((n, c), generator, device, rows))


def block_obstacle_ratio(cfg: EnvConfig, u: torch.Tensor) -> torch.Tensor:
    """level > 0: 0.05 * level; level 0: 0.15 * U[0,1); Empty: 0."""
    if cfg.map_type == "Empty":
        return torch.zeros_like(u)
    if cfg.level > 0:
        return torch.full_like(u, cfg.level * 0.05)
    return 0.15 * u


def generate_block_map(cfg: EnvConfig, draws: MapDraws) -> torch.Tensor:
    """(N, S, S) uint8 wall maps: a uniform obstacle scatter over the 80x80
    interior (the first floor(ratio * 6400) cells of a permutation), wall pad."""
    interior = cfg.maze_size - 2
    n_cells = interior * interior
    ratio = block_obstacle_ratio(cfg, draws.ratio_u)
    num_obstacles = torch.floor(ratio * n_cells).to(torch.int64)
    rank = torch.arange(n_cells, device=ratio.device)
    chosen = (rank[None, :] < num_obstacles[:, None]).to(torch.uint8)
    flat = torch.zeros_like(chosen).scatter_(1, draws.perm, chosen)
    maze = flat.reshape(-1, interior, interior)
    return torch.nn.functional.pad(maze, (1, 1, 1, 1), value=1)


def maze_complexity_density(cfg: EnvConfig, u: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk's loop counts per row, (N,) int64 each.

    r = 0.02 * level (level > 0) or 0.03 * U[0,1) (level 0), in float32;
    complexity = floor(r * 5 * (S + S)), density = floor(r * (S//2)^2).
    """
    if cfg.level > 0:
        r = torch.full_like(u, cfg.level * 0.02)
    else:
        r = 0.03 * u
    s = cfg.maze_size
    complexity = torch.floor(r * (5 * (s + s))).long()
    density = torch.floor(r * ((s // 2) * (s // 2))).long()
    return complexity, density


def maze_loop_bounds(cfg: EnvConfig) -> Tuple[int, int]:
    """(max_complexity, max_density): static bounds of the walk's loops."""
    s = cfg.maze_size
    r_max = cfg.level * 0.02 if cfg.level > 0 else 0.03
    max_complexity = int(math.floor(r_max * 5 * (s + s))) + 1
    max_density = int(math.floor(r_max * (s // 2) * (s // 2))) + 1
    return max_complexity, max_density


#: walk offsets (d_row, d_col) in the reference's order: left, right, up, down.
_WALK_OFFSETS = ((0, -2), (0, 2), (-2, 0), (2, 0))


@functools.lru_cache(maxsize=None)
def _walk_tables(s: int, device: torch.device):
    """Lookup tables of the walk step, made once per side and device.

    code24 (S*S,) int64: 24 x the cell's 4-bit mask of valid neighbours (in
    the reference's order: x > 1, x < S-2, y > 1, y < S-2). step (16*24,)
    int64: the flat cell offset that draw index r2*12 + r3*4 + r4 picks from
    a cell of each mask, where r_m is the draw from [0, m) and the mask's
    number of valid neighbours says which m applies (r = 0 with one valid
    neighbour; the first offset with none, as argmax of all-False gives).
    """
    idx = torch.arange(s * s)
    y, x = idx // s, idx % s
    code = ((x > 1).long() | (x < s - 2).long() << 1 | (y > 1).long() << 2
            | (y < s - 2).long() << 3)
    step = torch.zeros(16 * 24, dtype=torch.int64)
    for c in range(16):
        valid = [k for k in range(4) if c >> k & 1]
        for r2, r3, r4 in itertools.product(range(2), range(3), range(4)):
            r = {2: r2, 3: r3, 4: r4}.get(len(valid), 0)
            dy, dx = _WALK_OFFSETS[valid[r] if valid else 0]
            step[c * 24 + r2 * 12 + r3 * 4 + r4] = dy * s + dx
    return (code * 24).to(device), step.to(device)


def generate_maze_map(cfg: EnvConfig, draws: MapDraws) -> torch.Tensor:
    """(N, S, S) uint8 wall maps by the aisle-growing random walk, S odd.

    For each of `density` starts (on even cells, which may lie on the border,
    as in the reference), mark the start and walk up to `complexity` steps:
    pick one of the valid neighbours two cells away (left, right, up, down,
    in that order) with the draw for their number and, if it is free, wall
    it and the cell between. The loops run to their static bounds with
    inactive steps masked, in lock step over the rows; positions are flat
    cell indices, so a step is a few table lookups.
    """
    s = cfg.maze_size
    n = draws.ratio_u.shape[0]
    dev = draws.ratio_u.device
    complexity, density = maze_complexity_density(cfg, draws.ratio_u)
    max_complexity, max_density = maze_loop_bounds(cfg)
    code24, step = _walk_tables(s, dev)
    z = torch.zeros((n, s, s), dtype=torch.uint8, device=dev)
    z[:, 0, :] = z[:, -1, :] = z[:, :, 0] = z[:, :, -1] = 1
    z = z.reshape(n, s * s)
    starts = (draws.walk_start[..., 0] * s + draws.walk_start[..., 1]) * 2
    picks = (draws.walk_pick * torch.tensor([12, 4, 1], device=dev)).sum(-1)
    active_i = torch.arange(max_density, device=dev) < density[:, None]
    active = (active_i[:, :, None]
              & (torch.arange(max_complexity, device=dev)
                 < complexity[:, None, None]))        # (N, D, C)

    for i in range(max_density):
        cell = starts[:, i, None]
        z.scatter_(1, cell, z.gather(1, cell) | active_i[:, i, None])
        for j in range(max_complexity):
            nxt = cell + step[code24[cell] + picks[:, i, j, None]]
            free = z.gather(1, nxt) == 0
            do = active[:, i, j, None] & free
            both = torch.cat([nxt, (cell + nxt) // 2], dim=1)
            z.scatter_(1, both, z.gather(1, both) | do)
            cell = torch.where(do, nxt, cell)
    return z.reshape(n, s, s)


def generate_map(cfg: EnvConfig, draws: MapDraws) -> torch.Tensor:
    if cfg.map_type == "Maze":
        return generate_maze_map(cfg, draws)
    return generate_block_map(cfg, draws)


def _gumbel_topk_cells(gumbel: torch.Tensor, mask: torch.Tensor,
                       k: int) -> torch.Tensor:
    """k distinct cells (row, col) uniform over mask, by Gumbel top-k.

    gumbel (N, S*S), mask (N, S, S) bool -> (N, k, 2) int32. Ties go to the
    lower flat index, as ``lax.top_k`` does.
    """
    s = mask.shape[-1]
    g = torch.where(mask.reshape(mask.shape[0], -1), gumbel, _NEG)
    picks = []
    for _ in range(k):
        idx = torch.argmax(g, dim=-1)
        picks.append(idx)
        g = g.scatter(1, idx[:, None], float("-inf"))
    idx = torch.stack(picks, dim=1)
    return torch.stack([idx // s, idx % s], dim=-1).to(torch.int32)


def sample_free_cells(gumbel: torch.Tensor, maze: torch.Tensor,
                      k: int) -> torch.Tensor:
    """k distinct free cells per map, (N, k, 2) int32."""
    return _gumbel_topk_cells(gumbel, maze == 0, k)


def sample_around(gumbel: torch.Tensor, maze: torch.Tensor, state: torch.Tensor,
                  max_distance: int = 1) -> torch.Tensor:
    """A free cell in rows [max(0,x-d), min(S-1,x+d)) x cols [max(0,y-d),
    min(S-1,y+d)) around `state` (N, 2).

    The +d row and column are excluded: the reference's half-open slice, an
    off-by-one kept for parity. -> (N, 2) int32.
    """
    s = maze.shape[-1]
    x0 = (state[:, 0] - max_distance).clamp_min(0)[:, None, None]
    x1 = (state[:, 0] + max_distance).clamp_max(s - 1)[:, None, None]
    y0 = (state[:, 1] - max_distance).clamp_min(0)[:, None, None]
    y1 = (state[:, 1] + max_distance).clamp_max(s - 1)[:, None, None]
    idx = torch.arange(s, device=maze.device)
    rows, cols = idx[None, :, None], idx[None, None, :]
    window = (rows >= x0) & (rows < x1) & (cols >= y0) & (cols < y1)
    mask = window & (maze == 0)
    # cannot trigger for interior states: fall back to the state cell
    own = (rows == state[:, 0, None, None]) & (cols == state[:, 1, None, None])
    mask = torch.where(mask.flatten(1).any(1)[:, None, None], mask, own)
    return _gumbel_topk_cells(gumbel, mask, 1)[:, 0]


def sample_spawns(cfg: EnvConfig, maze: torch.Tensor, draws: SpawnDraws,
                  patrol: torch.Tensor | None = None):
    """Spawns and goals for fresh maps -> (init_pos (N,2,2), goals (N,2,2)).

    The tracker takes a uniform free cell (RPF: patrol[0]), the target a free
    cell in the tracker's window, and the two goals distinct free cells,
    redrawn up to 8 times while either equals the tracker spawn.
    """
    n = maze.shape[0]
    if cfg.target_mode == "RPF":
        assert patrol is not None
        tracker = patrol[0].expand(n, 2)
        goals = patrol[1].expand(n, 2, 2)
    else:
        tracker = sample_free_cells(draws.tracker, maze, 1)[:, 0]
        goals = sample_free_cells(draws.goals, maze, 2)
        for i in range(_SPAWN_RETRIES):
            clash = (goals == tracker[:, None, :]).all(-1).any(-1)
            fresh = sample_free_cells(draws.retry[:, i], maze, 2)
            goals = torch.where(clash[:, None, None], fresh, goals)
    target = sample_around(draws.target, maze, tracker, 1)
    return torch.stack([tracker, target], dim=1), goals


def patrol_goals(cfg: EnvConfig, device) -> torch.Tensor:
    """RPF patrol corners at the map's sixth-points, (4, 2) int32."""
    s = cfg.maze_size
    return torch.tensor(
        [[int(s / 6), int(s / 6)],
         [int(s * 5 / 6), int(s / 6)],
         [int(s * 5 / 6), int(s * 5 / 6)],
         [int(s / 6), int(s * 5 / 6)]], dtype=torch.int32, device=device)


def carve_patrol(maze: torch.Tensor, patrol: torch.Tensor) -> torch.Tensor:
    """Free the patrol cells of every map."""
    maze = maze.clone()
    maze[:, patrol[:, 0].long(), patrol[:, 1].long()] = 0
    return maze
