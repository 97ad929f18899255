"""The cap rule of the bit-parallel BFS kernel (active_tracking_rl_torch/
csrc/flood_bfs.cu), on the CPU.

``bfs_model`` is the kernel's level loop in Python, with each grid row a
bitset held in a Python int (the kernel splits a row into 32-bit words and
the rows into lanes; the logic per level is the same). Its fields must
equal, bit for bit:

* under cap = iters (flood_sweep_launch's cap), the sweep twin ``flood_fields_plain`` and JAX's
  ``flood_fields_pallas(variant="sweep")`` in interpret mode;
* under cap = ``relax_cap(iters)`` = 16 * ceil(iters / 16), 0 for iters <=
  0 (flood_relax_launch's cap), the relax twin ``flood_fields_relax_plain``
  and ``flood_fields_pallas(variant="relax")``.

The kernel itself runs only on the card, where chip_smoke.py and
tests/test_torch_cuda.py hold it to the same twins.
"""

import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.ops.flood_pallas import flood_fields_pallas
from active_tracking_rl_torch.ops import flood

S = 24
ITERS = [0, 1, 15, 16, 17, 20, 48]
DENSITIES = {"walls15": 0.15, "walls35": 0.35}


def bfs_model(maze: np.ndarray, goal, cap: int) -> np.ndarray:
    """One field of flood_bfs.cu: (S, S) uint8 maze, goal (row, col) ->
    (S, S) int16, the BFS distance where it is <= cap, INF elsewhere."""
    s = maze.shape[0]
    # free and not yet reached; bit c of row r is cell (r, c), and no bit
    # at or beyond column s is ever set, so the grid's edge acts as a wall
    avail = [sum(1 << c for c in range(s) if maze[r, c] == 0)
             for r in range(s)]
    out = np.full((s, s), flood.INF, np.int16)
    front = [0] * s
    r0, c0 = (int(x) for x in goal)
    if 0 <= r0 < s and 0 <= c0 < s and avail[r0] >> c0 & 1:
        front[r0] = 1 << c0
        avail[r0] &= ~front[r0]
        out[r0, c0] = 0
    for level in range(1, cap + 1):
        nxt = [((front[r - 1] if r > 0 else 0)
                | (front[r + 1] if r < s - 1 else 0)
                | front[r] << 1 | front[r] >> 1) & avail[r]
               for r in range(s)]
        if not any(nxt):
            break
        for r in range(s):
            avail[r] &= ~nxt[r]
            bits = nxt[r]
            while bits:
                out[r, (bits & -bits).bit_length() - 1] = level
                bits &= bits - 1
        front = nxt
    return out


def _case(name: str):
    """A maze of the density, and goals: four free, one (-1, -1) pad, one
    off the grid's far edge, one on a wall."""
    rng = np.random.RandomState(7 if name == "walls15" else 8)
    maze = (rng.rand(S, S) < DENSITIES[name]).astype(np.uint8)
    free = np.argwhere(maze == 0)
    goals = free[rng.choice(len(free), 4, replace=False)]
    goals = np.concatenate([goals, [[-1, -1], [S, 3], np.argwhere(maze)[0]]])
    return maze, goals.astype(np.int32)


CASES = {name: _case(name) for name in DENSITIES}


def _model(name: str, cap: int) -> np.ndarray:
    maze, goals = CASES[name]
    return np.stack([bfs_model(maze, g, cap) for g in goals])


def _twin(fn, name: str, iters: int) -> np.ndarray:
    maze, goals = CASES[name]
    return fn(torch.from_numpy(maze)[None], torch.from_numpy(goals)[None],
              iters)[0].numpy()


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("name", sorted(DENSITIES))
def test_model_matches_sweep_twin(name, iters):
    np.testing.assert_array_equal(
        _model(name, iters),
        _twin(flood.flood_fields_plain, name, iters))


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("name", sorted(DENSITIES))
def test_model_matches_relax_twin(name, iters):
    np.testing.assert_array_equal(
        _model(name, flood.relax_cap(iters)),
        _twin(flood.flood_fields_relax_plain, name, iters))


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("name", sorted(DENSITIES))
def test_model_matches_pallas_sweep(name, iters):
    maze, goals = CASES[name]
    want = np.asarray(flood_fields_pallas(maze, goals, iters, interpret=True,
                                          variant="sweep"))
    np.testing.assert_array_equal(_model(name, iters), want)


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("name", sorted(DENSITIES))
def test_model_matches_pallas_relax(name, iters):
    maze, goals = CASES[name]
    want = np.asarray(flood_fields_pallas(maze, goals, iters, interpret=True,
                                          variant="relax"))
    np.testing.assert_array_equal(_model(name, flood.relax_cap(iters)), want)


def test_cases_cover_every_kind_of_field():
    """The cap binds in some cases and not in others; the pad, the far
    edge and the wall goal give all-INF fields; the 35% maze has walls
    that cut some free cells off every free goal."""
    for name in DENSITIES:
        full = _model(name, S * S)
        deepest = full[full < flood.INF].max()
        assert 17 < deepest < 48, (name, deepest)
        assert (full[4:] == flood.INF).all()
        assert (full[:4] < flood.INF).any(axis=(1, 2)).all()
    maze, _ = CASES["walls35"]
    unreached = (_model("walls35", S * S)[:4] == flood.INF) & (maze == 0)
    assert unreached.all(axis=0).any()


@pytest.mark.parametrize("iters,cap", [(-3, 0), (0, 0), (1, 16), (16, 16),
                                       (17, 32), (256, 256), (257, 272)])
def test_relax_cap_is_whole_chunks(iters, cap):
    """The Python copy of flood_relax_launch's cap rule."""
    assert flood.relax_cap(iters) == cap
