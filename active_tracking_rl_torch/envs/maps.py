"""Block/Empty map generation and spawn sampling, batched over rows.

Port of ``active_tracking_rl_tpu/envs/maps.py``. Every function takes a
batch of N maps and its random draws as tensors (``MapDraws``,
``SpawnDraws``); ``draw_map`` and ``draw_spawns`` make them from a
``torch.Generator``. Fed the draws that ``jax.random`` made, each function
returns the JAX package's result bit for bit.

The maze walk (``generate_maze_map``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from active_tracking_rl_torch.config import EnvConfig
from active_tracking_rl_torch.ops import noise

#: large finite "minus infinity" for masked Gumbel sampling.
_NEG = -1e9
#: goal resamples while a goal sits on the tracker spawn.
_SPAWN_RETRIES = 8


@dataclasses.dataclass
class MapDraws:
    obstacle_u: torch.Tensor   # (N,) float32 U[0,1): obstacle ratio (Block level 0)
    perm: torch.Tensor         # (N, (S-2)^2) int64: obstacle cell permutation


@dataclasses.dataclass
class SpawnDraws:
    tracker: torch.Tensor      # (N, S*S) float32 Gumbel: tracker cell
    goals: torch.Tensor        # (N, S*S) Gumbel: the two goals
    retry: torch.Tensor        # (N, 8, S*S) Gumbel: goal resamples
    target: torch.Tensor       # (N, S*S) Gumbel: target cell near the tracker


def draw_map(cfg: EnvConfig, n: int, generator: torch.Generator,
             device) -> MapDraws:
    interior = cfg.maze_size - 2
    return MapDraws(
        obstacle_u=torch.rand((n,), generator=generator, device=device),
        perm=noise.permutations(n, interior * interior, generator, device))


def draw_spawns(cfg: EnvConfig, n: int, generator: torch.Generator,
                device) -> SpawnDraws:
    c = cfg.maze_size ** 2
    return SpawnDraws(
        tracker=noise.gumbel((n, c), generator, device),
        goals=noise.gumbel((n, c), generator, device),
        retry=noise.gumbel((n, _SPAWN_RETRIES, c), generator, device),
        target=noise.gumbel((n, c), generator, device))


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
    ratio = block_obstacle_ratio(cfg, draws.obstacle_u)
    num_obstacles = torch.floor(ratio * n_cells).to(torch.int64)
    rank = torch.arange(n_cells, device=ratio.device)
    chosen = (rank[None, :] < num_obstacles[:, None]).to(torch.uint8)
    flat = torch.zeros_like(chosen).scatter_(1, draws.perm, chosen)
    maze = flat.reshape(-1, interior, interior)
    return torch.nn.functional.pad(maze, (1, 1, 1, 1), value=1)


def generate_map(cfg: EnvConfig, draws: MapDraws) -> torch.Tensor:
    if cfg.map_type == "Maze":
        raise NotImplementedError("Maze map generation is not ported yet")
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
