"""The port's relax and sweep16 flood variants (active_tracking_rl_torch/ops/
flood.py) against the JAX package's Pallas kernels run in interpret mode,
bit for bit, as tests/test_flood_pallas.py runs them on the CPU.

On the CPU ``flood_fields`` runs each variant's plain twin: the relax twin is
the relaxation run to ``iters`` rounded up to a whole 16-sweep chunk, which
is what the TPU kernel ``_relax_kernel`` does.
"""

import jax
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import EnvConfig
from active_tracking_rl_tpu.envs import maps
from active_tracking_rl_tpu.envs.distance import distance_fields
from active_tracking_rl_tpu.ops.flood_pallas import flood_fields_pallas
from active_tracking_rl_torch.ops import flood

MAPS = {
    "block1": np.array(maps.generate_block_map(
        EnvConfig(map_type="Block", level=1), jax.random.PRNGKey(0))),
    "maze": np.array(maps.generate_map(
        EnvConfig(map_type="Maze", level=1), jax.random.PRNGKey(7))),
}


def _goals(name: str, g: int) -> np.ndarray:
    """g - 1 free goals and one (-1, -1) pad."""
    goals = np.array(maps.sample_free_cells(jax.random.PRNGKey(g),
                                            MAPS[name], g))
    goals[-1] = -1
    return goals


def _port(variant, m, goals, iters):
    return flood.flood_fields(torch.from_numpy(m)[None],
                              torch.from_numpy(goals)[None], iters,
                              variant)[0].numpy()


@pytest.mark.parametrize("g", [4, 9])
@pytest.mark.parametrize("iters", [20, 48, 96])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_relax_twin_matches_pallas_relax(name, iters, g):
    m, goals = MAPS[name], _goals(name, g)
    want = np.asarray(flood_fields_pallas(m, goals, iters, interpret=True,
                                          variant="relax"))
    got = _port("relax", m, goals, iters)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iters,g", [(20, 9), (48, 4), (96, 9)])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_sweep16_twin_matches_pallas_sweep16(name, iters, g):
    m, goals = MAPS[name], _goals(name, g)
    want = np.asarray(flood_fields_pallas(m, goals, iters, interpret=True,
                                          variant="sweep16"))
    got = _port("sweep16", m, goals, iters)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port("sweep", m, goals, iters))


def test_relax_runs_whole_chunks_past_iters():
    """At iters 20 the relaxation runs 32 sweeps: finite distances up to 32
    where the capped relaxation has INF beyond 20. At 48 both agree."""
    m = np.zeros((24, 24), np.uint8)
    goals = np.array([[0, 0], [23, 23]], np.int32)
    relax = _port("relax", m, goals, 20)
    capped = np.asarray(distance_fields(m, goals, 20))
    finite = relax[relax < flood.INF]
    assert finite.max() == 32 and capped[capped < flood.INF].max() == 20
    assert (relax != capped).any()
    np.testing.assert_array_equal(_port("relax", m, goals, 48),
                                  np.asarray(distance_fields(m, goals, 48)))


def test_flood_fields_rejects_unknown_variant():
    m = torch.zeros((1, 8, 8), dtype=torch.uint8)
    g = torch.zeros((1, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        flood.flood_fields(m, g, 16, "jacobi")


@pytest.mark.parametrize("variant", ["relax", "sweep16"])
def test_new_kernels_refuse_cpu_tensors(variant):
    """The CUDA wrappers refuse CPU tensors instead of running a twin."""
    kernel = flood.KERNELS[variant]
    before = kernel.launches
    with pytest.raises(ValueError):
        kernel(torch.from_numpy(MAPS["maze"])[None],
               torch.zeros((1, 1, 2), dtype=torch.int32), 48)
    assert kernel.launches == before
