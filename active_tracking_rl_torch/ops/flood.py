"""BFS flood fill: the CUDA fast-sweep kernel, its plain twin, the dispatch.

``flood_fields(maze, goals, iters)`` takes a batch of mazes (N, S, S) uint8
and goals (N, G, 2) int32 and returns (N, G, S, S) int16 distance fields:
the BFS distance where it is <= iters, INF = 16000 elsewhere and at walls.
That is the contract of the iteration-capped relaxation
``active_tracking_rl_tpu/envs/distance.py:distance_fields``.

* On a CPU tensor it runs ``flood_fields_plain``, the relaxation written
  out in PyTorch (the kernel's oracle).
* On a CUDA tensor it launches ``csrc/flood_sweep.cu`` (which replaces the
  TPU kernel ``_sweep_kernel`` of ``active_tracking_rl_tpu/ops/flood_pallas.py``)
  or raises. It never falls back to the plain version.

The kernel is compiled with ``nvcc`` into a shared library with a plain C
interface at first use, into ``active_tracking_rl_torch/_build/`` (listed in
``.gitignore``), and loaded with ``ctypes``. A library newer than its source
is reused.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

#: "unreachable" distance; fits int16 with headroom for +1 relaxation adds.
INF = 16000

#: fast-sweep round cap (each round handles about two more turns of a path);
#: 2x headroom over the ~65 rounds a 256-step path can need.
MAX_ROUNDS = 128

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "flood_sweep.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: the kernel keeps an int32 field and a uint8 wall mask per block in static-
#: limit (48 KB) dynamic shared memory.
_SMEM_LIMIT = 48 * 1024


def _seed_fields(wall: torch.Tensor, goals: torch.Tensor) -> torch.Tensor:
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
    """The kernel's plain twin: `iters` synchronous min-plus relaxation sweeps.

    Stops early once a sweep changes nothing: the sweep is then a fixpoint,
    so the result is that of all `iters` sweeps.
    """
    wall = (maze != 0)[:, None]
    d = _seed_fields(wall, goals)
    for i in range(iters):
        p = F.pad(d, (1, 1, 1, 1), value=INF)
        best = torch.minimum(torch.minimum(p[..., :-2, 1:-1], p[..., 2:, 1:-1]),
                             torch.minimum(p[..., 1:-1, :-2], p[..., 1:-1, 2:]))
        nd = torch.where(wall, INF, torch.minimum(d, best + 1))
        if i % 16 == 15 and torch.equal(nd, d):
            break
        d = nd
    return d


class FloodSweepKernel:
    """ctypes binding of ``csrc/flood_sweep.cu`` with its launch count."""

    name = "flood_sweep"

    def __init__(self) -> None:
        #: launches of the kernel, counted where it launches and nowhere else.
        self.launches = 0
        #: seconds the last build() took in nvcc (None: reused or not built).
        self.build_seconds = None
        #: the compiler's output (ptxas register and shared-memory report).
        self.build_log = ""
        self._fn = None

    def build(self) -> Path:
        """Compile the source with nvcc unless a newer library exists.

        Sets `build_seconds` to nvcc's time, or to None when it reused the
        library.
        """
        lib = BUILD_DIR / "libflood_sweep.so"
        self.build_seconds = None
        if lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{res.stderr}")
        os.replace(tmp, lib)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = res.stdout + res.stderr
        return lib

    def _load(self):
        if self._fn is None:
            fn = ctypes.CDLL(str(self.build())).flood_sweep_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, maze: torch.Tensor, goals: torch.Tensor,
                 iters: int) -> torch.Tensor:
        if maze.device.type != "cuda" or goals.device != maze.device:
            raise ValueError("flood_sweep needs maze and goals on one CUDA "
                             f"device, got {maze.device} and {goals.device}")
        if maze.dtype != torch.uint8 or goals.dtype != torch.int32:
            raise TypeError(f"flood_sweep takes uint8 mazes and int32 goals, "
                            f"got {maze.dtype} and {goals.dtype}")
        n, s, s2 = maze.shape
        if s != s2 or goals.shape[0] != n or goals.dim() != 3 \
                or goals.shape[2] != 2:
            raise ValueError(f"flood_sweep takes (N,S,S) mazes and (N,G,2) "
                             f"goals, got {tuple(maze.shape)} and "
                             f"{tuple(goals.shape)}")
        if s * s * 5 > _SMEM_LIMIT:
            raise ValueError(f"flood_sweep holds S*S*5 bytes in shared "
                             f"memory; S={s} is too large")
        if not (maze.is_contiguous() and goals.is_contiguous()):
            raise ValueError("flood_sweep takes contiguous tensors")
        g = goals.shape[1]
        out = torch.empty((n, g, s, s), dtype=torch.int16, device=maze.device)
        fn = self._load()
        with torch.cuda.device(maze.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(maze.data_ptr(), goals.data_ptr(), out.data_ptr(),
                     n, g, s, int(iters), MAX_ROUNDS, stream)
        if err != 0:
            raise RuntimeError(f"flood_sweep launch failed: CUDA error {err}")
        self.launches += 1
        return out


#: the process's one binding of the kernel; its `launches` is read by
#: chip_smoke.py to show that the main path went through it.
FLOOD_SWEEP = FloodSweepKernel()


def flood_fields(maze: torch.Tensor, goals: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Dispatch by device: the plain twin on the CPU, the kernel on CUDA."""
    if maze.device.type == "cpu":
        return flood_fields_plain(maze, goals, iters)
    if maze.device.type == "cuda":
        return FLOOD_SWEEP(maze, goals, iters)
    raise ValueError(f"flood_fields: no implementation for {maze.device}")
