"""The port's distance-field dispatch (active_tracking_rl_torch/envs/
distance.py) against the JAX package, bit for bit: the exact fast sweep
``distance_fields_sweep`` (also where 64 rounds do not converge) and every
``distance_fields_backend`` name.

On the CPU the kernel backends run their plain twins; the JAX package's
Pallas backends run in interpret mode, as tests/test_flood_pallas.py runs
them.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import EnvConfig
from active_tracking_rl_tpu.envs import distance as jdist
from active_tracking_rl_tpu.envs import maps
from active_tracking_rl_tpu.ops.flood_pallas import flood_fields_pallas
from active_tracking_rl_torch.envs import distance as tdist
from active_tracking_rl_torch.ops import flood

ITERS = 96


def staircase(side: int) -> np.ndarray:
    """A one-cell-wide diagonal staircase from (1, 1) to (side-2, side-2):
    a turn at every step, so fast sweeping needs ~side rounds."""
    m = np.ones((side, side), np.uint8)
    for i in range(1, side - 1):
        m[i, i] = 0
        if i + 1 < side - 1:
            m[i, i + 1] = 0
    return m


MAPS = {
    "block0": np.array(maps.generate_block_map(
        EnvConfig(map_type="Block", level=0), jax.random.PRNGKey(3))),
    "maze": np.array(maps.generate_map(
        EnvConfig(map_type="Maze", level=0), jax.random.PRNGKey(4))),
    "staircase": staircase(81),
}


def _goals(name: str) -> np.ndarray:
    """Three goals: a free cell, the free cell farthest from it in the
    staircase, a (-1, -1) pad; plus a goal on a wall."""
    m = MAPS[name]
    free = np.argwhere(m == 0)
    rng = np.random.RandomState(len(name))
    pick = free[rng.choice(len(free), 1)]
    if name == "staircase":
        pick = np.array([[1, 1]])
    wall = np.argwhere(m == 1)[:1]
    return np.concatenate([pick, free[-1:], [[-1, -1]], wall]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_backend(backend):
    """The JAX counterpart of each port backend name, compiled once."""
    if backend in ("pallas", "pallas_sweep", "auto"):
        variant = "relax" if backend == "pallas" else "sweep"
        return lambda m, g: flood_fields_pallas(m, g, ITERS, interpret=True,
                                                variant=variant)
    return jax.jit(functools.partial(jdist.distance_fields_backend,
                                     iters=ITERS, backend=backend))


def _port(m, goals, backend):
    return tdist.distance_fields_backend(torch.from_numpy(m),
                                         torch.from_numpy(goals), ITERS,
                                         backend).numpy()


@pytest.mark.parametrize("name", sorted(MAPS))
def test_distance_fields_sweep_matches_jax(name):
    m, goals = MAPS[name], _goals(name)
    want = np.asarray(jax_backend("sweep")(m, goals))
    got = tdist.distance_fields_sweep(torch.from_numpy(m),
                                      torch.from_numpy(goals)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_distance_fields_sweep_stops_at_64_rounds():
    """The staircase needs more than 64 rounds: the fast sweep's field stops
    short of the BFS one there, and the port stops exactly where JAX does."""
    m, goals = MAPS["staircase"], _goals("staircase")
    got = tdist.distance_fields_sweep(torch.from_numpy(m),
                                      torch.from_numpy(goals)).numpy()
    exact = tdist.distance_fields_sweep(torch.from_numpy(m),
                                        torch.from_numpy(goals),
                                        max_rounds=200).numpy()
    assert (got != exact).any()
    assert exact[0, 79, 79] == 156
    np.testing.assert_array_equal(
        exact, np.asarray(jdist.distance_fields(m, goals, 256)))


@pytest.mark.parametrize("backend", ["auto", "pallas_sweep", "pallas",
                                     "xla", "sweep"])
@pytest.mark.parametrize("name", ["block0", "maze"])
def test_backend_matches_jax(name, backend):
    m, goals = MAPS[name], _goals(name)
    want = np.asarray(jax_backend(backend)(m, goals))
    np.testing.assert_array_equal(_port(m, goals, backend), want)


def test_backend_batched_rows_match_single_maps():
    names = ["block0", "maze"]
    for backend in tdist.BACKENDS:
        for name in names:
            m, goals = MAPS[name], _goals(name)
            got = tdist.distance_fields_backend(
                torch.from_numpy(m)[None].repeat(2, 1, 1),
                torch.from_numpy(goals)[None].repeat(2, 1, 1), ITERS, backend)
            np.testing.assert_array_equal(got[1].numpy(),
                                          _port(m, goals, backend))


def test_backend_rejects_unknown_name():
    m = torch.from_numpy(MAPS["block0"])
    with pytest.raises(ValueError):
        tdist.distance_fields_backend(m, torch.zeros((1, 2), dtype=torch.int32),
                                      ITERS, "mosaic")


@pytest.mark.parametrize("backend,kernel", [("auto", "sweep"),
                                            ("pallas_sweep", "sweep"),
                                            ("pallas", "relax")])
def test_kernel_backends_on_cpu_run_twins(backend, kernel):
    """On CPU tensors no kernel launches; the twin of `kernel` runs."""
    m, goals = MAPS["maze"], _goals("maze")
    before = {v: k.launches for v, k in flood.KERNELS.items()}
    got = _port(m, goals, backend)
    want = flood.PLAIN[kernel](torch.from_numpy(m)[None],
                               torch.from_numpy(goals)[None], ITERS)[0]
    np.testing.assert_array_equal(got, want.numpy())
    assert {v: k.launches for v, k in flood.KERNELS.items()} == before
