"""BFS flood fill: the CUDA kernels, their plain twins, the dispatch.

``flood_fields(maze, goals, iters, variant)`` takes a batch of mazes
(N, S, S) uint8 and goals (N, G, 2) int32 and returns (N, G, S, S) int16
distance fields, walls and unreached cells at INF = 16000. The variants are
those of ``flood_fields_pallas`` in ``active_tracking_rl_tpu/ops/flood_pallas.py``:

* ``"sweep"`` and ``"sweep16"``: the BFS distance where it is <= iters, INF
  elsewhere (the contract of the iteration-capped relaxation
  ``active_tracking_rl_tpu/envs/distance.py:distance_fields``; the TPU
  kernel ``_sweep_kernel`` with an int32 or an int16 carry). Kernel: the
  bit-parallel frontier BFS of ``csrc/flood_bfs.cu`` capped at iters, one
  launcher each. Twin: ``flood_fields_plain``.
* ``"relax"``: synchronous relaxation in chunks of 16 sweeps, so up to
  ceil(iters / 16) * 16 sweeps, as the TPU kernel ``_relax_kernel`` runs;
  from one seed that is the BFS capped at ceil(iters / 16) * 16. Kernel:
  ``csrc/flood_bfs.cu`` under that cap. Twin: ``flood_fields_relax_plain``.

On a CPU tensor ``flood_fields`` runs the variant's twin. On a CUDA tensor it
launches the variant's kernel or raises; it never falls back to the twin.

The CUDA source is compiled with ``nvcc`` into a shared library with a plain
C interface at first use, into ``active_tracking_rl_torch/_build/`` (listed
in ``.gitignore``), and loaded with ``ctypes``. A library newer than its own
source is reused. ``build_all`` builds every library in ``LIBRARIES`` at
once, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch
import torch.nn.functional as F

#: "unreachable" distance; fits int16 with headroom for +1 relaxation adds.
INF = 16000

#: sweeps per convergence check of the relaxation kernel.
CHECK_EVERY = 16

#: the largest side the kernels take: the BFS kernel's rows are at most 4
#: words, and at 128 its two staged fields a block (a byte a cell) fit the
#: 48 KB a block holds without opting in for more.
MAX_SIDE = 128

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

VARIANTS = ("relax", "sweep", "sweep16")


def seed_fields(wall: torch.Tensor, goals: torch.Tensor) -> torch.Tensor:
    """(N,1,S,S) bool x (N,G,2) -> (N,G,S,S) int16: 0 at the goal, INF elsewhere.

    A goal off the grid or on a wall seeds nothing (an all-INF field).
    """
    s = wall.shape[-1]
    idx = torch.arange(s, device=wall.device)
    is_goal = ((idx[:, None] == goals[..., 0, None, None])
               & (idx[None, :] == goals[..., 1, None, None]) & ~wall)
    return torch.where(is_goal, 0, INF).to(torch.int16)


def flood_fields_plain(maze: torch.Tensor, goals: torch.Tensor,
                       iters: int) -> torch.Tensor:
    """The sweep kernels' plain twin: `iters` synchronous min-plus relaxation
    sweeps.

    Stops early once a sweep changes nothing: the sweep is then a fixpoint,
    so the result is that of all `iters` sweeps.
    """
    wall = (maze != 0)[:, None]
    d = seed_fields(wall, goals)
    for i in range(iters):
        p = F.pad(d, (1, 1, 1, 1), value=INF)
        best = torch.minimum(torch.minimum(p[..., :-2, 1:-1], p[..., 2:, 1:-1]),
                             torch.minimum(p[..., 1:-1, :-2], p[..., 1:-1, 2:]))
        nd = torch.where(wall, INF, torch.minimum(d, best + 1))
        if i % 16 == 15 and torch.equal(nd, d):
            break
        d = nd
    return d


def relax_cap(iters: int) -> int:
    """The sweeps `_relax_kernel` runs: whole CHECK_EVERY-sweep chunks while
    fewer than `iters` have run. From one seed that many sweeps give the BFS
    capped there (csrc/flood_bfs.cu derives it)."""
    return max(0, -(-iters // CHECK_EVERY)) * CHECK_EVERY


def flood_fields_relax_plain(maze: torch.Tensor, goals: torch.Tensor,
                             iters: int) -> torch.Tensor:
    """The relaxation kernel's plain twin: the same sweeps, `iters` rounded
    up to a whole number of CHECK_EVERY-sweep chunks."""
    return flood_fields_plain(maze, goals, relax_cap(iters))


class KernelLibrary:
    """One CUDA source under ``csrc/``, built by nvcc into one library."""

    def __init__(self, source_name: str) -> None:
        self.source_name = source_name
        #: seconds the last build() took in nvcc (None: reused or not built).
        self.build_seconds = None
        #: the compiler's output (ptxas register and shared-memory report).
        self.build_log = ""
        self._cdll = None

    @property
    def source(self) -> Path:
        return CSRC_DIR / self.source_name

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"lib{Path(self.source_name).stem}.so"

    def build(self) -> Path:
        """Compile the source with nvcc unless a library newer than it exists.

        Sets `build_seconds` to nvcc's time, or to None when it reused the
        library.
        """
        lib, src = self.path, self.source
        self.build_seconds = None
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
        os.replace(tmp, lib)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = res.stdout + res.stderr
        return lib

    def function(self, symbol: str):
        """The launcher `symbol`: int f(maze, goals, out, n, g, s, iters,
        extra, stream), its pointers and stream as c_void_p."""
        if self._cdll is None:
            self._cdll = ctypes.CDLL(str(self.build()))
        fn = getattr(self._cdll, symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn


class FloodKernel:
    """ctypes binding of one flood launcher, with its launch count."""

    def __init__(self, name: str, library: KernelLibrary, symbol: str,
                 extra: int) -> None:
        self.name = name
        self.library = library
        self.symbol = symbol
        #: the launcher's last int: the relaxation's check cadence, or 0 for
        #: the sweep launchers, which read none.
        self.extra = extra
        #: launches of the kernel, counted where it launches and nowhere else.
        self.launches = 0
        self._fn = None

    def __call__(self, maze: torch.Tensor, goals: torch.Tensor,
                 iters: int) -> torch.Tensor:
        name = self.name
        if maze.device.type != "cuda" or goals.device != maze.device:
            raise ValueError(f"{name} needs maze and goals on one CUDA "
                             f"device, got {maze.device} and {goals.device}")
        if maze.dtype != torch.uint8 or goals.dtype != torch.int32:
            raise TypeError(f"{name} takes uint8 mazes and int32 goals, "
                            f"got {maze.dtype} and {goals.dtype}")
        n, s, s2 = maze.shape
        if s != s2 or goals.shape[0] != n or goals.dim() != 3 \
                or goals.shape[2] != 2:
            raise ValueError(f"{name} takes (N,S,S) mazes and (N,G,2) goals, "
                             f"got {tuple(maze.shape)} and "
                             f"{tuple(goals.shape)}")
        if not 1 <= s <= MAX_SIDE:
            raise ValueError(f"{name} takes sides 1 to {MAX_SIDE}, got S={s}")
        if not (maze.is_contiguous() and goals.is_contiguous()):
            raise ValueError(f"{name} takes contiguous tensors")
        g = goals.shape[1]
        out = torch.empty((n, g, s, s), dtype=torch.int16, device=maze.device)
        if self._fn is None:
            self._fn = self.library.function(self.symbol)
        with torch.cuda.device(maze.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._fn(maze.data_ptr(), goals.data_ptr(), out.data_ptr(),
                           n, g, s, int(iters), self.extra, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        self.launches += 1
        return out


BFS_LIB = KernelLibrary("flood_bfs.cu")
LIBRARIES = (BFS_LIB,)

#: the process's one binding of each launcher, each with its own count;
#: chip_smoke.py reads them (`launches()`) to show which variant a path ran.
FLOOD_SWEEP = FloodKernel("flood_sweep", BFS_LIB, "flood_sweep_launch", 0)
FLOOD_SWEEP16 = FloodKernel("flood_sweep16", BFS_LIB, "flood_sweep16_launch",
                            0)
FLOOD_RELAX = FloodKernel("flood_relax", BFS_LIB, "flood_relax_launch",
                          CHECK_EVERY)

KERNELS = {"sweep": FLOOD_SWEEP, "sweep16": FLOOD_SWEEP16,
           "relax": FLOOD_RELAX}
PLAIN = {"sweep": flood_fields_plain, "sweep16": flood_fields_plain,
         "relax": flood_fields_relax_plain}


def launches() -> Dict[str, int]:
    """Each launcher's count so far, by its name."""
    return {k.name: k.launches for k in KERNELS.values()}


def build_all() -> None:
    """Build every library, one nvcc per source, all started together."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for fut in [pool.submit(lib.build) for lib in LIBRARIES]:
            fut.result()


def flood_fields(maze: torch.Tensor, goals: torch.Tensor, iters: int,
                 variant: str) -> torch.Tensor:
    """Dispatch by device: the variant's twin on the CPU, its kernel on CUDA."""
    if variant not in VARIANTS:
        raise ValueError(f"flood_fields: unknown variant {variant!r}")
    if maze.device.type == "cpu":
        return PLAIN[variant](maze, goals, iters)
    if maze.device.type == "cuda":
        return KERNELS[variant](maze, goals, iters)
    raise ValueError(f"flood_fields: no implementation for {maze.device}")
