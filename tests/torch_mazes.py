"""Maze inputs for the port's flood-kernel checks, in numpy alone (no JAX):
used by tests/test_torch_cuda.py and by chip_smoke.py."""

from __future__ import annotations

import numpy as np


def perfect_maze(side: int, rng: np.random.RandomState) -> np.ndarray:
    """A maze with exactly one path between any two free cells."""
    m = np.ones((side, side), np.uint8)
    m[1, 1] = 0
    stack = [(1, 1)]
    while stack:
        r, c = stack[-1]
        nbrs = [(r + dr, c + dc) for dr, dc in ((-2, 0), (2, 0), (0, -2), (0, 2))
                if 0 < r + dr < side - 1 and 0 < c + dc < side - 1
                and m[r + dr, c + dc] == 1]
        if not nbrs:
            stack.pop()
            continue
        nr, nc = nbrs[rng.randint(len(nbrs))]
        m[(r + nr) // 2, (c + nc) // 2] = 0
        m[nr, nc] = 0
        stack.append((nr, nc))
    return m
