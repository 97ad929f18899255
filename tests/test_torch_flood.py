"""The port's flood fill (active_tracking_rl_torch/ops/flood.py) against the
JAX package's oracle ``envs/distance.py:distance_fields`` and the NumPy BFS
(tests/oracles.py), bit for bit. Mirrors tests/test_flood_pallas.py. Also the
nvcc build of the CUDA source, and of two sources at once, against a stub
compiler.

On the CPU the dispatch runs the kernels' plain twins; the CUDA kernels
themselves are held against their twins on the card by chip_smoke.py (and by
test_cuda_kernel_matches_twin below when a card is present).
"""

import os
import subprocess

import jax
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import EnvConfig
from active_tracking_rl_tpu.envs import maps
from active_tracking_rl_tpu.envs.distance import distance_fields
from active_tracking_rl_torch.envs import distance as tdist
from active_tracking_rl_torch.ops import flood
from tests.oracles import bfs_distance

INF = 16000


def numpy_maze(side: int, seed: int) -> np.ndarray:
    """A perfect maze (one path between any two cells) on an odd grid."""
    rng = np.random.RandomState(seed)
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


def _free_goals(m: np.ndarray, k: int, seed: int) -> np.ndarray:
    free = np.argwhere(m == 0)
    rng = np.random.RandomState(seed)
    return free[rng.choice(len(free), k, replace=False)].astype(np.int32)


def _maps():
    block0 = np.array(maps.generate_block_map(
        EnvConfig(map_type="Block", level=0), jax.random.PRNGKey(0)))
    block1 = np.array(maps.generate_block_map(
        EnvConfig(map_type="Block", level=1), jax.random.PRNGKey(1)))
    empty = np.array(maps.generate_block_map(
        EnvConfig(map_type="Empty"), jax.random.PRNGKey(2)))
    return {"block0": block0, "block1": block1, "empty": empty,
            "numpy_maze": numpy_maze(81, 3)}


MAPS = _maps()


@pytest.fixture(scope="module")
def jax_fields():
    """distance_fields compiled once per iters value."""
    return {it: jax.jit(lambda m, g, it=it: distance_fields(m, g, it))
            for it in (48, 96, 256)}


def _goals_with_pads(m, k, seed):
    g = _free_goals(m, k, seed)
    pads = np.full((2, 2), -1, np.int32)
    wall = np.argwhere(m == 1)[:1].astype(np.int32)   # a goal on a wall
    return np.concatenate([g, pads, wall])


@pytest.mark.parametrize("iters", [48, 96, 256])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_twin_matches_jax_oracle(jax_fields, name, iters):
    m = MAPS[name]
    goals = _goals_with_pads(m, 5, iters)
    want = np.asarray(jax_fields[iters](m, goals))
    got = tdist.distance_fields(torch.from_numpy(m), torch.from_numpy(goals),
                                iters).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iters", [48, 256])
@pytest.mark.parametrize("name", ["block0", "numpy_maze"])
def test_twin_matches_bfs_oracle_capped(name, iters):
    m = MAPS[name]
    goals = _free_goals(m, 3, 7)
    got = tdist.distance_fields(torch.from_numpy(m), torch.from_numpy(goals),
                                iters).numpy()
    for g, field in zip(goals, got):
        want = bfs_distance(m, g)
        want[want > iters] = INF
        np.testing.assert_array_equal(field, want)


def test_batched_twin_matches_per_map(jax_fields):
    """(N, S, S) mazes with (N, G, 2) goals, G not a multiple of 16, equal
    the per-map JAX fields."""
    names = ["block0", "block1", "empty"]
    mz = np.stack([MAPS[n] for n in names])
    goals = np.stack([_goals_with_pads(MAPS[n], 6, i)
                      for i, n in enumerate(names)])
    got = flood.flood_fields_plain(torch.from_numpy(mz),
                                   torch.from_numpy(goals), 96).numpy()
    for i in range(len(names)):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax_fields[96](mz[i], goals[i])))


def test_backend_on_cpu_is_the_twin():
    m = torch.from_numpy(MAPS["block1"])[None].repeat(2, 1, 1)
    goals = torch.from_numpy(
        np.stack([_goals_with_pads(MAPS["block1"], 4, s) for s in (1, 2)]))
    before = flood.FLOOD_SWEEP.launches
    got = tdist.distance_fields_backend(m, goals, 96)
    np.testing.assert_array_equal(
        got.numpy(), flood.flood_fields_plain(m, goals, 96).numpy())
    assert flood.FLOOD_SWEEP.launches == before


def test_dispatch_rejects_other_devices():
    m = torch.zeros((1, 82, 82), dtype=torch.uint8, device="meta")
    g = torch.zeros((1, 2, 2), dtype=torch.int32, device="meta")
    for variant in flood.VARIANTS:
        with pytest.raises(ValueError):
            flood.flood_fields(m, g, 48, variant)


def test_kernel_wrapper_never_runs_the_twin():
    """The CUDA wrapper refuses CPU tensors instead of falling back."""
    m = torch.from_numpy(MAPS["empty"])[None]
    g = torch.zeros((1, 1, 2), dtype=torch.int32)
    before = flood.FLOOD_SWEEP.launches
    with pytest.raises(ValueError):
        flood.FLOOD_SWEEP(m, g, 48)
    assert flood.FLOOD_SWEEP.launches == before


def test_kernel_source_builds_with_nvcc_alone():
    """Plain C launchers for ctypes, sm_90a, no PyTorch headers."""
    for kernel in flood.KERNELS.values():
        src = kernel.library.source.read_text()
        assert f'extern "C" int {kernel.symbol}(' in src
        assert "torch/extension.h" not in src and "ATen" not in src
    assert [lib.source.name for lib in flood.LIBRARIES] == ["flood_bfs.cu"]
    assert all(k.library is flood.BFS_LIB for k in flood.KERNELS.values())
    assert "arch=compute_90a,code=sm_90a" in flood.NVCC_FLAGS
    assert "-shared" in flood.NVCC_FLAGS
    assert flood.BUILD_DIR.name == "_build"


def test_sweep16_binds_the_bfs_library():
    """flood_sweep16 is the BFS kernel under its own launcher and count:
    the library of flood_sweep, a symbol and a binding of its own, and a
    launcher that, like flood_sweep's, reads no extra argument."""
    sweep, sweep16 = flood.FLOOD_SWEEP, flood.FLOOD_SWEEP16
    assert sweep16.library is sweep.library is flood.BFS_LIB
    assert (sweep16.symbol, sweep.symbol) == ("flood_sweep16_launch",
                                              "flood_sweep_launch")
    assert sweep16 is not sweep and sweep16.extra == sweep.extra == 0
    assert flood.KERNELS["sweep16"] is sweep16
    assert flood.PLAIN["sweep16"] is flood.PLAIN["sweep"]
    assert not hasattr(flood, "MAX_ROUNDS") and not hasattr(flood,
                                                            "SWEEP_LIB")
    assert not (flood.CSRC_DIR / "flood_sweep.cu").exists()


#: two sources for the build tests: the real name and a second stub, so that
#: building several libraries at once stays covered.
STUB_SOURCES = ("flood_bfs.cu", "second_stub.cu")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """flood.CSRC_DIR (with two stub sources) and BUILD_DIR in tmp_path; nvcc
    replaced by a stub that writes its -o file. Yields the list of the
    stub's command lines."""
    (tmp_path / "csrc").mkdir()
    for name in STUB_SOURCES:
        (tmp_path / "csrc" / name).write_text("// kernel source")
    monkeypatch.setattr(flood, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(flood, "BUILD_DIR", tmp_path / "_build")
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"library")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info: 32 registers")

    monkeypatch.setattr(flood.subprocess, "run", run)
    return calls


@pytest.mark.parametrize("lib_is_newer", [True, False])
def test_build_reuses_only_a_newer_library(fake_nvcc, lib_is_newer):
    for i, source in enumerate(STUB_SOURCES):
        library = flood.KernelLibrary(source)
        calls = len(fake_nvcc)
        lib = library.build()         # nothing built yet: nvcc runs
        assert len(fake_nvcc) == calls + 1 and lib.read_bytes() == b"library"
        assert fake_nvcc[-1][-1] == str(library.source)
        assert lib.name == f"lib{source[:-3]}.so"
        assert library.build_seconds is not None
        t = library.source.stat().st_mtime + (10 if lib_is_newer else -10)
        os.utime(lib, (t, t))
        assert library.build() == lib
        assert len(fake_nvcc) == calls + (1 if lib_is_newer else 2)
        assert (library.build_seconds is None) == lib_is_newer


def test_each_library_rebuilds_for_its_own_source_only(fake_nvcc):
    """Touching one source rebuilds its library and reuses the other."""
    other, bfs = (flood.KernelLibrary(STUB_SOURCES[1]),
                  flood.KernelLibrary(STUB_SOURCES[0]))
    libs = [other.build(), bfs.build()]
    for lib in libs:
        os.utime(lib, (1e9 + 20, 1e9 + 20))
    os.utime(other.source, (1e9, 1e9))
    os.utime(bfs.source, (1e9 + 40, 1e9 + 40))   # newer than its library
    assert len(fake_nvcc) == 2
    other.build()
    bfs.build()
    assert len(fake_nvcc) == 3 and fake_nvcc[-1][-1] == str(bfs.source)
    assert other.build_seconds is None and bfs.build_seconds is not None


def test_smoke_build_phase_reports_a_reused_library(fake_nvcc, monkeypatch,
                                                    capsys):
    """chip_smoke.py's build line, run twice in one checkout: one nvcc per
    source, started together, then every library reused; with the one real
    library, and with two stub libraries."""
    import chip_smoke
    for names in (STUB_SOURCES[:1], STUB_SOURCES):
        calls = len(fake_nvcc)
        monkeypatch.setattr(flood, "LIBRARIES", tuple(
            flood.KernelLibrary(n) for n in names))
        chip_smoke.phase_build(flood)
        out = capsys.readouterr().out
        assert out.count("nvcc") == len(names) and "reused" not in out
        chip_smoke.phase_build(flood)
        assert capsys.readouterr().out.count("reused") == len(names)
        assert len(fake_nvcc) == calls + len(names)
        for lib in flood.LIBRARIES:     # the next round builds afresh
            lib.path.unlink()


@pytest.mark.cuda
def test_cuda_kernel_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    names = sorted(MAPS)
    for name in names:
        m = torch.from_numpy(MAPS[name])[None].repeat(3, 1, 1)
        goals = torch.from_numpy(np.stack(
            [_goals_with_pads(MAPS[name], 13, s) for s in range(3)]))
        for iters in (20, 48, 256):
            for variant in flood.VARIANTS:
                want = flood.PLAIN[variant](m, goals, iters)
                got = flood.flood_fields(m.cuda(), goals.cuda(), iters,
                                         variant).cpu()
                np.testing.assert_array_equal(got.numpy(), want.numpy())
