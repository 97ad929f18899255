#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of the repository, with no install step:

    python3 chip_smoke.py

With `--tat-seeds 0-7` it runs only the TAT-continuous bar of phase 17,
for each seed on the card and on the CPU (`--tat-devices`; `--tat-control`
adds each seed at train mode 0, where the aux head does not learn), each
run in a spawned process, and prints every run and each device's summary.
With `--update-check [TRACKER]` it runs only phase 4's update check, at
the K=16 Nav recipe's batch (1024 envs, a pool of 256), from fresh
parameters, from the sharpened tracker and from the flax-format tracker
file TRACKER if one is given.

Phases (each prints one line with its seconds):
  1. device: needs CUDA, prints `nvidia-smi --query-gpu=name,power.limit`,
     the float32 settings that utils/platform.py:pin_float32 leaves (no
     TF32) and the deterministic mode that pin_deterministic leaves
     (deterministic algorithms, cuDNN without benchmarking,
     CUBLAS_WORKSPACE_CONFIG), as every entry point of the port pins them;
  2. build: compiles csrc/flood_bfs.cu, the one kernel source (its launchers
     flood_sweep, flood_sweep16 and flood_relax), with nvcc (plain C
     interface, ctypes); prints ptxas's registers, shared memory and spills
     for each instance of the kernel;
  3. kernel: each flood launcher (flood_sweep, flood_sweep16, flood_relax)
     against its plain PyTorch twin on the card, bit for bit, on 512 mazes
     at S=82 (Block maps of two densities, Empty maps) and on mazes of side
     81 (perfect mazes and the port's own maze walk), with 16, 13 and 4 goals
     with (-1,-1) pads and goals on walls, at iters 20, 48 and 256 (20 pins
     the relaxation's whole 16-sweep chunks); then the caps: iters 0, 1, 15,
     16, 17, 255 and 256 on the perfect mazes, whose paths are far longer
     than 256, on Block and Empty maps at S=82, at S=24 and at S=128, the
     kernel's largest side; then the host trainer's shape, one row (a
     GymTrackEnv reset): 4 Block and 4 Empty maps at S=82, each alone with
     16 goals and with 4 goals holding (-1,-1) pads, at iters 256 and 20;
     then dp-train's shapes, a rank's 256-row pool block and its 2048-row
     initial carry of Block maps, 16 goals at the env's flood_iters (each
     also timed for flood_sweep); flood_sweep16 must also equal
     flood_sweep; prints each launcher's, its twin's and its bound's time
     on a 512-row pool and on one row, and the depth of the timed fields
     with the levels that their output implies;
  4. reference: the port on the card against the port on the CPU (where the
     floods are the plain twins): ops/noise.py's draws from the same seeds
     (bits, uniforms, integers, permutations, the noise of a K=16 Nav train
     step at 1024 envs and the draws of a 256-row Nav pool) equal bit for
     bit, each device's Gumbel noise within 2 ulp of max(|g|, 1) of
     float64's -log(-log u) of the same u; reset and 3 steps bit for bit
     (float state to 1e-6) for one id of every (map, obs, target) at level 0, a Moore
     config and Track2D-MazePartialRPF-v0 on the relaxation kernel; one
     8-step train step's loss to 1e-4 relative, on the Block main path's id
     and on Track2D-MazeFullRPF-v0, one AD-VAT train step at mode -1
     (loss and pred_loss), and one each of maze-gru with SharedRMSprop,
     icml-lstm on Full obs and tat-cnn-lstm on Full obs; the greedy
     evaluator on the AD-VAT eval env, 8 episodes of 60 steps, episode
     lengths equal and returns to 1e-5; and one train step of the K=16
     Nav recipe's config as the trainer CLI builds it (tat-maze-lstm on
     Track2D-BlockPartialNav-v0, train mode 0, remat on, 20 steps) at 256
     envs and a pool of 64, from the same state, parameters and noise,
     the CPU taking the card's relu decisions where the two differ (each
     such flip a tie of rounding, and few; ReluDecisions): the carry
     equal, and the loss and every gradient to 1e-4 of its
     tensor's largest entry, every updated parameter to 1e-4 of its
     layer's largest entry, from fresh parameters
     and from the same model with its tracker's policy head scaled until
     its first-step entropy is below 0.05 (the worst relative difference
     of each of the tracker's tensor families printed); then
     [reference-host]: GymTrackEnv
     on Track2D-BlockPartialNav-v0 and Track2D-BlockPartialPZR-v0, reset and
     20 fixed-action steps from the same draws (obs and done equal, integer
     state bit for bit, floats to 1e-6), and one make_host_update of
     maze-lstm-continuous single and of tat-maze-lstm-continuous with the
     aux reward at mode -1 (loss, grad norm and pred_loss to 1e-4
     relative);
  5. main: Track2D-BlockPartialNav-v0 (flood_backend "auto": flood_sweep),
     maze-lstm at full width, train mode 0, 4096 envs, a reset pool of 512
     refreshed every iteration, 20 steps, remat off (TrainConfig's default;
     maze-main and advat too), float32 without TF32, through
     run/bench.py's build_bench and time_bench: init_learner, one untimed
     warm-up step, then 3 timed train steps; the losses must be finite,
     flood_sweep must have been launched in the timed steps (and as often
     in the warm-up step) and flood_relax and flood_sweep16 must not;
     prints their (warm) env-steps/s, then the time of one reset pool, of
     its parts (map, spawns, tape with its floods; run/profile_iter.py's
     pool_parts) and of one train step on a given pool; then repro: the
     main path's train step twice from one state, its parameters,
     optimizer state, carry and metrics equal bit for bit;
  6. maze-main: the same on Track2D-MazePartialNav-v0 with flood_backend
     "pallas": flood_relax must be launched, flood_sweep and flood_sweep16
     must not; then bench-flood: run/bench_flood.py at 64 rows x 16 goals
     (1 warm-up and 2 timed calls of each backend on Block and Maze maps):
     the "pallas" and "pallas_sweep" fields equal on 8 rows of each
     (its sweep_equals_relax), and each kernel launched 8 times;
  7. advat: AD-VAT at full width, the advat-2d preset (tat-maze-lstm on
     Track2D-BlockPartialPZR-v0, static train mode -1, amsgrad Adam, target
     entropy 0.2) at 4096 envs, a pool of 512 refreshed every iteration, 20
     steps, init_step 3: the curriculum picks each iteration's mode, so the
     untimed warm-up (iteration 1) and the first timed step run mode 0 and
     the next two -1; the losses must be finite, pred_loss must stay out of
     the loss at mode 0 and enter it at -1, and no flood kernel may run (PZR
     episodes have no scripted tape); prints env-steps/s, each step's
     seconds, the losses and pred_losses, then the time of one reset pool
     and of one train step on it;
  8. advat-eval: the greedy evaluator with the trained players on the
     preset's env_base, Track2D-BlockPartialNav-v0, 100 episodes of 500
     steps; its reset must launch flood_sweep and no other flood kernel;
     prints S_rate, EL_mean and the seconds;
  9. sweep16-entry: flood_fields(variant="sweep16"), the int16 variant's
     only entry point, on one main-path reset pool's mazes and goals;
 10. cli-train: the trainer CLI, `run/train.py:main`, at the JAX CLI's
     defaults (AD-VAT: tat-maze-lstm on Track2D-BlockPartialPZR-v0, train
     mode -1, remat on, evaluated on Track2D-BlockPartialNav-v0) at 4096
     envs, a pool of 512, init_step 3, 6 iterations, a checkpoint every 3;
     every iteration's metrics finite (--debug-nans), the JSONL rows of
     iteration 1 and the evals at 3 and 6, the parameter files,
     train_state.pt and ckpt_meta.json at 6; flood_sweep launched exactly
     once per eval reset and no other kernel;
 11. cli-resume: --resume of that run to iteration 8; before it steps, the
     parameters, optimizer state, carry and generator state it loaded equal
     the saved ones and the first run's last, bit for bit; it starts at
     iteration 7 with the saved curriculum and watermark; at iteration 8
     its parameters, optimizer state and carry equal, bit for bit, those
     of one uninterrupted 8-iteration run of the same flags (evaluated at
     8 only), and so do the two evals at 8;
 12. cli-eval: run/eval.py on cli-train's tracker and target files, 100
     episodes on Nav: S_rate and EL_mean equal, R_mean to 1e-5, those of
     rl/evaluate.py on the same parameters and seed; then
     run/eval_matrix.py with the tracker (2 seeds, Wilson CI);
 13. cli-nets: the CLI at 1024 envs, a pool of 256, 2 iterations, with
     maze-gru + RMSprop, icml-lstm on Full obs, tat-cnn-gru on Full obs
     with --bf16, and tat-maze-lstm with --no-remat; then one train step's
     gradients with and without remat from one state, to 1e-5 relative;
 14. host-train: the host-env trainer CLI, `run/train_host.py:main`, with
     --device cuda on Track2D-BlockPartialNav-v0 through the gym bridge,
     maze-lstm at full width, 16 envs x 20 steps, 1 iteration, one
     checkpoint: the loss finite, the all-, tracker- and target- parameter
     files written, flood_sweep launched exactly once per env reset (the
     pool counts its resets) and no other kernel; prints env-steps/s, the
     seconds, the resets and the launches;
 15. learn: tests/test_learning_smoke.py's bar through the library:
     maze-lstm on Block-Ram (remat off, as there), 125 iterations (the
     test's 150, cut) at 128 envs must lift the greedy return by more
     than 30 and the episode length by more than 20;
 16. host-single: a single-player discrete maze-lstm HostTrainer on a toy
     single-agent env (tests/test_host_loop.py's): every episode, of
     length 10, is recorded;
 17. learn-continuous and learn-tat-continuous: the bars of the JAX slow
     tests on the card, on this script's numpy copies of their direction
     pools (32 envs x 8 steps): maze-lstm-continuous single, 120
     iterations, late return > early + 2 and > 4 (tests/test_continuous.py);
     tat-maze-lstm-continuous with the aux reward at mode -1, 150
     iterations at each of trainer seeds 0-4 (LEARN_TAT_SEEDS), tests/
     test_continuous_tat.py's bar as written (late > early + 2, and the
     mean pred_loss of the last 20 iterations < 0.8 x that of the first
     20) met by a majority of the seeds on the card and on the CPU (the
     same seeds in spawned processes that overlap phases 13 to 17; the
     draws are the same on either device), and each seed's pred_loss of
     the card within 1e-3 of the CPU's over the first 60 iterations
     (LEARN_TAT_AGREE), before rounding parts the two runs;
 18. random-agent: `run/random_agent.py:main` on Track2D-BlockPartialNav-v0,
     FPS mode at 4096 envs for 3 s (its reset must launch flood_sweep, and
     no other kernel), then --episodes 1 without --gif (one launch);
 19. dp-train: the trainer CLI, `run/train.py:main`, as 2 spawned ranks
     over gloo sharing cuda:0 (NCCL takes one card per rank), on the main
     config (maze-lstm on Track2D-BlockPartialNav-v0, train mode 0) at
     4096 envs, a pool of 512, 20 steps, 3 iterations, a checkpoint and an
     eval of 8 episodes at 3: both ranks' parameter digests and eval lines
     equal; rank 1's run dir (`-r1`) holds no parameter file, no
     train_state.pt and no ckpt_meta.json; each rank launched flood_sweep
     on its 2048-row initial carry, on its 256-row pool block each
     iteration and on the eval's reset, and no other kernel; the final
     parameters equal, to 1e-5 of each tensor's largest entry, those of
     the same seed in one process with pool_blocks=2; prints env-steps/s
     (a check that the path runs: two ranks share one card);
 20. scaling: `parallel/scaling.py --dp 1 2` at 1024 envs per device: a
     row at dp 1 (a spawned rank, 3 timed steps) and a skipped row at dp 2
     naming the one card;
 21. dp-nccl: `parallel/mp_check.py` as one spawned rank, a process group
     of one over nccl on cuda:0, started with phase 20 and overlapping it:
     its digest (a hash of every parameter's bytes), loss and launches
     (none) equal, bit for bit, those of the same 3 steps in this process
     without a process group;
 22. profile: `run/profile_summary.py --capture`: torch.profiler over 3
     train steps of maze-lstm on Track2D-BlockPartialNav-v0 at 4096 envs on
     a given pool; the summary must come from device events, its kernel,
     memcpy, memset and idle shares sum to 1 within 1e-3; prints the top 5
     ops, the kernel share and the idle share;
 23. demo: `run/demo.py` with cli-train's tracker and target files, one
     greedy Nav episode: frames = episode length + 1, flood_sweep launched
     once (the reset); writes the GIF where PIL imports, else shows that
     --gif raises and runs without it; prints which case held;
 24. parity: `run/parity.py` record, then verify, on the card (exit 0);
     verify of a copy with one observation changed exits 1.
Then one JSON line with the kernel table (each row also carries the levels
its timed output implies, its times at one row, `host_shape`, and its
launches on every path), the card's line from nvidia-smi, and the last line
{"ok": true, "device": {...}}. Any failure raises and the script exits
non-zero without the last line.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and 32-bit non-tensor ops/s.
PEAK_BYTES_S = 3.35e12
PEAK_OPS32_S = 67e12

BENCH_ENV = "Track2D-BlockPartialNav-v0"
MAZE_ENV = "Track2D-MazePartialNav-v0"
NUM_ENVS, RESET_POOL, NUM_STEPS, TRAIN_STEPS = 4096, 512, 20, 3
#: rows of each id's card-vs-CPU reset check
REFERENCE_ROWS = 8

ADVAT_PRESET = "advat-2d"
#: the curriculum's warmup: iterations below it train mode 0
ADVAT_INIT_STEP = 3
EVAL_EPISODES, EVAL_STEPS = 100, 500

#: (env id, train mode, network, optimizer) of the card-vs-CPU train steps
#: of the networks and optimizer beyond the main paths'
REFERENCE_NETS = (
    ("Track2D-BlockPartialNav-v0", 0, "maze-gru", "RMSprop"),
    ("Track2D-BlockFullNav-v0", 0, "icml-lstm", "Adam"),
    ("Track2D-BlockFullPZR-v0", -1, "tat-cnn-lstm", "Adam"))

#: the K=16 Nav recipe (runs/postrun5.sh:21-25) as the trainer CLI parses
#: it (remat on), less its --num-envs and --reset-pool
UPDATE_FLAGS = ["--env", BENCH_ENV, "--env-base", BENCH_ENV, "--network",
                "tat-maze-lstm", "--train-mode", "0", "--pool-refresh", "16"]
#: the reference phase's update check: the recipe's 1024 envs and pool of
#: 256 cut by 4 (tests/test_torch_cuda.py runs the recipe's batch)
UPDATE_ENVS, UPDATE_POOL = 256, 64
#: each gradient tensor, card against CPU, to this share of its largest
#: entry, and each updated parameter to this share of its layer's largest
#: entry (float32 on both sides, no TF32)
UPDATE_TOL = 1e-4
#: the low-entropy policy: its tracker's mean entropy at the first step
LOW_ENTROPY = 0.05

#: the trainer CLI's AD-VAT run: the JAX CLI's defaults at full width
CLI_TRAIN_FLAGS = ["--num-envs", "4096", "--reset-pool", "512",
                   "--init-step", "3", "--total-iters", "6",
                   "--checkpoint-every", "3", "--run-name", "smoke",
                   "--debug-nans"]
#: the CLI with each other network, 2 iterations at 1024 envs, a pool of 256
CLI_NETS = (
    ["--env", "Track2D-BlockPartialNav-v0", "--network", "maze-gru",
     "--optimizer", "RMSprop", "--train-mode", "0"],
    ["--env", "Track2D-BlockFullNav-v0", "--env-base",
     "Track2D-BlockFullNav-v0", "--network", "icml-lstm", "--train-mode",
     "0"],
    ["--env", "Track2D-BlockFullPZR-v0", "--env-base",
     "Track2D-BlockFullNav-v0", "--network", "tat-cnn-gru", "--train-mode",
     "-1", "--bf16"],
    ["--network", "tat-maze-lstm", "--no-remat"])
CLI_NETS_FLAGS = ["--num-envs", "1024", "--reset-pool", "256",
                  "--total-iters", "2", "--debug-nans"]

#: the learning bar of tests/test_learning_smoke.py, its 150 iterations cut
#: to 125 to hold the smoke's time
LEARN_ENV = "Track2D-BlockPartialRam-v0"
LEARN_ITERS, LEARN_EPISODES, LEARN_STEPS = 125, 64, 100

#: the host-env trainer CLI on the card: Nav through the gym bridge, cut to
#: 1 iteration (~20 one-row resets of ~0.35 s an iteration)
HOST_TRAIN_ITERS = 1
HOST_TRAIN_FLAGS = ["--env", "Track2D-BlockPartialNav-v0", "--network",
                    "maze-lstm", "--num-envs", "16", "--num-steps", "20",
                    "--total-iters", str(HOST_TRAIN_ITERS),
                    "--checkpoint-every", str(HOST_TRAIN_ITERS)]
#: the continuous learning bars of tests/test_continuous.py and
#: tests/test_continuous_tat.py: iterations at 32 envs x 8 steps
LEARN_CONT_ITERS, LEARN_TAT_CONT_ITERS = 120, 150
#: the trainer seeds of the TAT bar, which tests/test_continuous_tat.py
#: holds at one seed: here a majority of them must meet it on each device
#: (on the CPU, `--tat-seeds 0-10 --tat-devices cpu`, 7 of seeds 0-10 do
#: under ops/noise.py's draws; the JAX package's own seed 4 misses)
LEARN_TAT_SEEDS = (0, 1, 2, 3, 4)
#: the card and the CPU start from the same parameters and draw the same
#: noise, and only float order parts them, at a rate the runs amplify: over
#: the first LEARN_TAT_AGREE iterations each pred_loss of the card within
#: LEARN_TAT_AGREE_TOL of the CPU's, relative. The CPU with torch's native
#: conv against oneDNN's (the swap that gives the card's update to the
#: digit) stays within 2.1e-7 there on seeds 0-10, and first parts by 1e-3
#: at iteration 86; later, runs part wholly (seed 2, card against CPU:
#: x0.428 against x0.493), so the late iterations are held only through
#: each device's bar
LEARN_TAT_AGREE, LEARN_TAT_AGREE_TOL = 60, 1e-3
#: the random agent's FPS mode
RANDOM_AGENT_ENVS, RANDOM_AGENT_SECONDS = 4096, 3
#: dp-train: the trainer CLI on the main config as 2 gloo ranks sharing
#: cuda:0, 3 iterations and one small eval
DP_ENVS, DP_POOL, DP_ITERS, DP_TEST_EPS = 4096, 512, 3, 8
DP_TRAIN_FLAGS = ["--env", BENCH_ENV, "--env-base", BENCH_ENV,
                  "--network", "maze-lstm", "--aux", "none",
                  "--train-mode", "0", "--num-envs", str(DP_ENVS),
                  "--reset-pool", str(DP_POOL), "--num-steps",
                  str(NUM_STEPS), "--total-iters", str(DP_ITERS),
                  "--checkpoint-every", str(DP_ITERS), "--test-eps",
                  str(DP_TEST_EPS), "--run-name", "dp", "--device", "cuda",
                  "--dist-backend", "gloo"]
#: 2 ranks against one process with pool_blocks=2: each parameter tensor's
#: largest difference over its largest entry
DP_PARAM_RTOL = 1e-5
#: seconds a spawned rank, or a --dp value of the scaling harness, may take
DP_TIMEOUT = 300
#: the scaling harness: envs per device, timed steps
SCALING_ENVS, SCALING_ITERS = 1024, 3

#: run/bench_flood.py's rows and timed calls in the smoke (its default:
#: 512 rows, 5 calls)
BENCH_FLOOD_ROWS, BENCH_FLOOD_ITERS = 64, 2

SOURCES = {"flood_sweep": "active_tracking_rl_torch/csrc/flood_bfs.cu",
           "flood_sweep16": "active_tracking_rl_torch/csrc/flood_bfs.cu",
           "flood_relax": "active_tracking_rl_torch/csrc/flood_bfs.cu"}
REPLACES = {"flood_sweep": "active_tracking_rl_tpu/ops/flood_pallas.py:84",
            "flood_sweep16": "active_tracking_rl_tpu/ops/flood_pallas.py:84",
            "flood_relax": "active_tracking_rl_tpu/ops/flood_pallas.py:41"}


#: ops/noise.py's Gumbel noise on each device against float64's
#: -log(-log u) of the same u, in ulp of max(|g|, 1): each float32 log is
#: within 1 ulp of the exact one on either device (CUDA's logf, and the
#: CPU's Sleef logf u10 or libm logf); the inner one's error, relative to
#: -log u, moves g by at most 2^-23 after the outer log, which adds its own
#: ulp, so 2 in all, and the card and the CPU within twice that of each
#: other. Every other draw is equal bit for bit
GUMBEL_ULP = 2


def draw_gen(seed: int, device="cpu"):
    """The port's generator (ops/noise.py's threefry2x32) seeded with
    `seed`."""
    from active_tracking_rl_torch.ops import noise
    return noise.generator(seed, device)


def say(phase: str, t0: float, msg: str = "") -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.3f} s {msg}".rstrip(),
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build(flood) -> None:
    """Build every kernel library at once, or reuse those newer than their
    sources; one line per library."""
    t0 = time.perf_counter()
    flood.build_all()
    for lib in flood.LIBRARIES:
        if lib.build_seconds is None:
            say("build", t0, f"reused {lib.path} (newer than its source)")
            continue
        # per kernel: its entry, stack and spills, registers and smem
        ptxas = " | ".join(
            line.replace("ptxas info    :", "").strip()
            for line in lib.build_log.splitlines()
            if any(k in line for k in ("entry", "spill", "registers")))
        say("build", t0, f"{lib.source.name}: nvcc "
            f"{lib.build_seconds:.2f} s; {ptxas}")


def bound(mz, goals, out, inf):
    """The least time for the work, in ms, and what bounds it: the bytes
    moved (mazes and goals read once, int16 fields written once) at the HBM
    rate, or an exact BFS's operations (add + min for 4 neighbours at each
    reached cell) at the 32-bit rate."""
    bytes_moved = mz.numel() + goals.numel() * 4 + out.numel() * 2
    ops = 8 * int((out < inf).sum())
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, ops / PEAK_OPS32_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def depth(torch, out, inf, cap):
    """Depth statistics of fields (N, G, S, S): the mean and the largest
    finite distance per field, and the levels that the output implies the
    BFS kernel ran per field under `cap` (a field D deep runs D + 1 levels,
    the last finding nothing, or stops at the cap; a field with no seed runs
    1). The kernel counts no levels itself."""
    f = out.flatten(2).int()
    finite = f < inf
    seeded = finite.any(-1)
    far = torch.where(finite, f, -1).amax(-1)
    mean = (torch.where(finite, f, 0).sum(-1).double()
            / finite.sum(-1).clamp_min(1))
    levels = torch.where(seeded, torch.clamp(far + 1, max=cap), 1)
    return dict(
        fields=int(f.shape[0] * f.shape[1]), seeded=int(seeded.sum()),
        mean_dist=float(mean[seeded].mean()),
        mean_max_dist=float(far[seeded].double().mean()),
        max_dist=int(far.max()),
        implied_levels_mean=float(levels.double().mean()),
        implied_levels_max=int(levels.max()))


def phase_kernel(torch, flood, maps, tconfig, gen):
    """Each kernel against its twin, bit for bit; the kernels' table rows."""
    from active_tracking_rl_torch.ops import noise
    # by file path: an installed package named `tests` may shadow the
    # repository's tests/ directory, which is no package
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    from torch_mazes import perfect_maze

    t0 = time.perf_counter()
    dev = torch.device("cuda")

    def pool_maps(env_id, n, u=None):
        cfg = tconfig.parse_env_id(env_id)
        draws = maps.draw_map(cfg, n, gen, dev)
        if u is not None:
            draws.ratio_u.fill_(u)
        return maps.generate_map(cfg, draws).contiguous()

    def free_goals(mz, g):
        s = mz.shape[-1]
        return maps.sample_free_cells(
            noise.uniform((mz.shape[0], s * s), gen, dev),
            mz, g).contiguous()

    def padded(goals, g):
        goals = goals[:, :g].clone()
        goals[::3, -2:] = -1                  # (-1,-1) pads
        goals[1::3, 0] = 0                    # a goal on the border wall
        return goals

    errs = {name: 0 for name in SOURCES}

    def check(mz, goals, iters):
        """Every kernel once against its twin, bit for bit."""
        want = {"sweep": flood.flood_fields_plain(mz, goals, iters),
                "relax": flood.flood_fields_relax_plain(mz, goals, iters)}
        got = {v: flood.KERNELS[v](mz, goals, iters) for v in flood.VARIANTS}
        torch.cuda.synchronize()
        for v, out in got.items():
            ref = want["relax" if v == "relax" else "sweep"]
            err = int((out.int() - ref.int()).abs().max())
            name = flood.KERNELS[v].name
            errs[name] = max(errs[name], err)
            if err != 0:
                raise AssertionError(
                    f"{name} != twin: S={mz.shape[-1]} G={goals.shape[1]} "
                    f"iters={iters} max_abs_err={err}")
        if not torch.equal(got["sweep16"], got["sweep"]):
            raise AssertionError(f"flood_sweep16 != flood_sweep: "
                                 f"S={mz.shape[-1]} G={goals.shape[1]} "
                                 f"iters={iters}")

    mazes82 = torch.cat([
        pool_maps("Track2D-BlockPartialNav-v0", 171, u=1.0),  # 15% walls
        pool_maps("Track2D-BlockPartialNav-v1", 171),          # 5% walls
        pool_maps("Track2D-EmptyPartialNav-v0", 170)]).contiguous()
    rng = np.random.RandomState(0)
    perfect81 = torch.from_numpy(np.stack([perfect_maze(81, rng)
                                           for _ in range(16)])).to(dev)
    mazes81 = torch.cat([
        perfect81,
        pool_maps("Track2D-MazePartialNav-v0", 48),
        pool_maps("Track2D-MazePartialNav-v1", 48)]).contiguous()

    cases = 0
    for mz in (mazes82, mazes81):
        goals16 = free_goals(mz, 16)
        for g in (16, 13, 4):
            for iters in (20, 48, 256):
                check(mz, padded(goals16, g), iters)
                cases += 1
    say("kernel", t0, f"{cases} cases: flood_sweep, flood_sweep16 and "
        f"flood_relax == their twins bit for bit; flood_sweep16 == "
        f"flood_sweep")

    # the caps: perfect mazes, where the deepest cells are far beyond 256
    t1 = time.perf_counter()
    goals = padded(free_goals(perfect81, 16), 16)
    cap_iters = (0, 1, 15, 16, 17, 255, 256)
    for iters in cap_iters:
        check(perfect81, goals, iters)
    full = flood.flood_fields_plain(perfect81, goals, 81 * 81)
    deepest = int(full[full < flood.INF].max())
    if deepest <= 256:
        raise AssertionError(f"perfect mazes only {deepest} deep: the caps "
                             f"do not bind")
    # Block and Empty maps at S=82, the smallest side of the cases and the
    # kernel's largest (a perfect maze of 127 closed by a wall row and
    # column, and open maps), every one at every cap
    rng = np.random.RandomState(1)
    maze128 = np.ones((16, 128, 128), np.uint8)
    for i in range(8):
        maze128[i, :127, :127] = perfect_maze(127, rng)
    maze128[8:] = rng.rand(8, 128, 128) < 0.15
    side_cases = [
        (mazes82[::8], cap_iters),
        (torch.from_numpy((rng.rand(64, 24, 24) < 0.25).astype(np.uint8)),
         cap_iters + (20,)),
        (torch.from_numpy(maze128), cap_iters)]
    for mz, iters_list in side_cases:
        mz = mz.to(dev).contiguous()
        goals = padded(free_goals(mz, 16), 16)
        for iters in iters_list:
            check(mz, goals, iters)
    say("kernel-caps", t1, f"iters {cap_iters} on 16 perfect 81^2 mazes "
        f"(deepest cell {deepest}), on 64 Block and Empty maps at S=82, at "
        f"S=24 (and iters 20) and at S=128: every launcher == its twin bit "
        f"for bit; flood_sweep16 == flood_sweep")

    # the host trainer's shape: a GymTrackEnv reset on a Nav id floods one
    # row's goal fields (16 goals; 4 with two (-1,-1) pads)
    t2 = time.perf_counter()
    host_cases = 0
    for env_id in ("Track2D-BlockPartialNav-v0", "Track2D-EmptyPartialNav-v0"):
        mz = pool_maps(env_id, 4)
        goals16 = free_goals(mz, 16)
        for i in range(mz.shape[0]):
            for goals in (goals16[i:i + 1], padded(goals16[i:i + 1], 4)):
                for iters in (256, 20):
                    check(mz[i:i + 1], goals, iters)
                    host_cases += 1
    say("kernel-host", t2, f"{host_cases} cases of 1 row at S=82 (4 Block "
        f"and 4 Empty maps, 16 goals and 4 with (-1,-1) pads, iters 256 "
        f"and 20): every launcher == its twin bit for bit; flood_sweep16 "
        f"== flood_sweep")

    # times on the main paths' data (level-0 maps of the path's family, 16
    # free goals, iters 256), each output held against its twin once more
    rows = {}
    iters = tconfig.parse_env_id(BENCH_ENV).flood_iters
    inputs = {}
    for env_id in (BENCH_ENV, MAZE_ENV):
        mz = pool_maps(env_id, RESET_POOL)
        inputs[env_id] = (mz, free_goals(mz, 16))
    timed = [("flood_sweep", BENCH_ENV), ("flood_sweep16", BENCH_ENV),
             ("flood_relax", MAZE_ENV), ("flood_relax", BENCH_ENV),
             ("flood_sweep", MAZE_ENV)]
    for name, env_id in timed:
        variant = {"flood_sweep": "sweep", "flood_sweep16": "sweep16",
                   "flood_relax": "relax"}[name]
        kernel, plain = flood.KERNELS[variant], flood.PLAIN[variant]
        mz, goals = inputs[env_id]
        kernel_ms = cuda_ms(lambda: kernel(mz, goals, iters), 20)
        plain_ms = cuda_ms(lambda: plain(mz, goals, iters), 3)
        out = kernel(mz, goals, iters)
        err = int((out.int() - plain(mz, goals, iters).int()).abs().max())
        errs[name] = max(errs[name], err)
        if err != 0:
            raise AssertionError(f"{name} != twin on {env_id}'s pool: "
                                 f"max_abs_err={err}")
        bound_ms, bound_by = bound(mz, goals, out, flood.INF)
        cap = flood.relax_cap(iters) if variant == "relax" else iters
        stats = depth(torch, out, flood.INF, cap)
        n, g, s = mz.shape[0], goals.shape[1], mz.shape[-1]
        say("kernel-time", t0, f"{name} at {n}x{g}x{s}^2 iters {iters} "
            f"({env_id}): kernel {kernel_ms:.4f} ms, twin {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        say("kernel-depth", t0, f"{name} on {env_id}'s pool: " + ", ".join(
            f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in stats.items()))
        if name not in rows:  # the first line of each kernel is its row
            rows[name] = dict(
                name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=None,
                max_abs_err=None, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                implied_levels_mean=stats["implied_levels_mean"],
                implied_levels_max=stats["implied_levels_max"])
    # times at the host trainer's shape: one row, 16 goals
    for name, env_id in (("flood_sweep", BENCH_ENV),
                         ("flood_sweep16", BENCH_ENV),
                         ("flood_relax", MAZE_ENV)):
        variant = {"flood_sweep": "sweep", "flood_sweep16": "sweep16",
                   "flood_relax": "relax"}[name]
        kernel, plain = flood.KERNELS[variant], flood.PLAIN[variant]
        mz, goals = (x[:1] for x in inputs[env_id])
        kernel_ms = cuda_ms(lambda: kernel(mz, goals, iters), 200)
        plain_ms = cuda_ms(lambda: plain(mz, goals, iters), 3)
        out = kernel(mz, goals, iters)
        if not torch.equal(out, plain(mz, goals, iters)):
            raise AssertionError(f"{name} != twin at one row of {env_id}")
        bound_ms, bound_by = bound(mz, goals, out, flood.INF)
        shape = f"1x{goals.shape[1]}x{mz.shape[-1]}^2"
        rows[name]["host_shape"] = dict(
            shape=shape, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by)
        say("kernel-time-host", t0, f"{name} at {shape} iters {iters} "
            f"({env_id}): kernel {kernel_ms:.4f} ms, twin {plain_ms:.3f} "
            f"ms, bound {bound_ms:.5f} ms ({bound_by})")
    # dp-train's shapes: each of 2 ranks floods its 2048-row initial carry
    # and its 256-row pool block of the main env's maps, 16 goals at the
    # env's flood_iters; every launcher against its twin, flood_sweep timed
    t3 = time.perf_counter()
    carry_mz = pool_maps(BENCH_ENV, DP_ENVS // 2)
    carry_goals = free_goals(carry_mz, 16)
    dp_shapes = {}
    for n in (DP_POOL // 2, DP_ENVS // 2):
        mz, goals = carry_mz[:n].contiguous(), carry_goals[:n].contiguous()
        check(mz, goals, iters)
        kernel = flood.KERNELS["sweep"]
        kernel_ms = cuda_ms(lambda: kernel(mz, goals, iters), 20)
        plain_ms = cuda_ms(lambda: flood.PLAIN["sweep"](mz, goals, iters), 3)
        bound_ms, bound_by = bound(mz, goals, kernel(mz, goals, iters),
                                   flood.INF)
        shape = f"{n}x{goals.shape[1]}x{mz.shape[-1]}^2"
        dp_shapes[shape] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by)
        say("kernel-dp", t3, f"flood_sweep at {shape} iters {iters} "
            f"({BENCH_ENV}, dp-train's rank shape): every launcher == its "
            f"twin bit for bit; kernel {kernel_ms:.4f} ms, twin "
            f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    rows["flood_sweep"]["dp_shapes"] = dp_shapes
    for row in rows.values():  # every case of this phase counts
        row["max_abs_err"] = errs[row["name"]]
    return rows, inputs[BENCH_ENV]


def _to(x, dev):
    """A draws or state dataclass (or a tensor) on `dev`."""
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), dev)
                          for f in dataclasses.fields(x)})
    return x.to(dev) if x is not None else None


def _assert_state_close(torch, a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name).cpu()
        if x.is_floating_point():
            torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-6)
        elif not torch.equal(x, y):
            raise AssertionError(f"cuda != cpu in {what}.{f.name}")


def check_reset_steps(torch, env_mod, ecfg, gen_cpu, rows, what):
    """Reset and 3 steps on the card and on the CPU from the same draws."""
    from active_tracking_rl_torch.ops import noise
    draws = env_mod.draw_reset(ecfg, rows, gen_cpu, "cpu")
    actions = noise.randint(ecfg.num_actions, (3, rows, 2), gen_cpu, "cpu",
                            torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        state, obs = env_mod.reset(ecfg, _to(draws, dev))
        trace = [(state, obs)]
        for a in actions:
            state, obs, *_ = env_mod.step(ecfg, state, a.to(dev))
            trace.append((state, obs))
        out[dev] = trace
    for i, ((sc, oc), (sg, og)) in enumerate(zip(out["cpu"], out["cuda"])):
        _assert_state_close(torch, sc, sg, f"{what} step {i}")
        if not torch.equal(oc, og.cpu()):
            raise AssertionError(f"cuda != cpu in {what} step {i} obs")


def check_train_step(torch, tconfig, env_mod, learner, dueling, env_id,
                     train_mode, gen_cpu, network=None, optimizer="Adam"):
    """One 8-step train step at 16 envs (pool 8) on the card and the CPU,
    from the same reset draws, parameters and noise, at static train mode
    `train_mode` (the step's mode too), with `network` (default: the id's
    default network) and `optimizer`. Returns both losses and both
    pred_losses."""
    ecfg = tconfig.parse_env_id(env_id)
    tcfg = tconfig.TrainConfig(env_id=env_id, num_envs=16, reset_pool=8,
                               num_steps=8, train_mode=train_mode,
                               optimizer=optimizer)
    ncfg = tconfig.net_config_for(tcfg, network)
    draws = env_mod.draw_reset(ecfg, 24, gen_cpu, "cpu")
    noise = learner.draw_step_noise(8, tcfg.num_envs, ecfg.num_actions,
                                    gen_cpu, "cpu")
    params = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                 device="cpu", generator=gen_cpu).state_dict()
    results = {}
    for dev in ("cpu", "cuda"):
        env = env_mod.TrackEnv(ecfg, dev)
        state, obs = env.reset(_to(draws, dev))
        model = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                    device=dev)
        model.load_state_dict(params)
        opt = learner.make_optimizer_for(model, tcfg)
        n = tcfg.num_envs
        carry = learner.TrainCarry(
            state.map(lambda x: x[:n]), obs[:n, :, None],
            torch.zeros((n, 2, 128), device=dev),
            torch.zeros((n, 2, 128), device=dev), None)
        pool = (state.map(lambda x: x[n:]), obs[n:],
                learner.init_pool_ptr(device=dev))
        step = learner.make_train_step(model, env, ncfg, tcfg, opt)
        carry, metrics, _ = step(carry, train_mode, pool, learner.StepNoise(
            *(x.to(dev) for x in noise)))
        results[dev] = dict(state=state.map(lambda x: x.cpu()),
                            carry=carry.env_state.map(lambda x: x.cpu()),
                            loss=metrics.loss.item(),
                            pred_loss=metrics.pred_loss.item())
    for name in ("state", "carry"):
        _assert_state_close(torch, results["cpu"][name],
                            results["cuda"][name], f"{env_id} {name}")
    # float32 on both sides with TF32 off: only reduction order differs
    for name in ("loss", "pred_loss"):
        c, g = results["cpu"][name], results["cuda"][name]
        if not abs(c - g) <= 1e-4 * max(1.0, abs(c)):
            raise AssertionError(f"{env_id} train-step {name} cuda {g} != "
                                 f"cpu {c}")
    return ((results["cuda"]["loss"], results["cpu"]["loss"]),
            (results["cuda"]["pred_loss"], results["cpu"]["pred_loss"]))


def sharpen_tracker(torch, model, obs_stack, limit=LOW_ENTROPY):
    """Scale the tracker's policy head (weight and bias) by powers of 2
    until its mean entropy at the first step on `obs_stack`, from a zero
    recurrent state, is below `limit` -> (scale, entropy)."""
    from active_tracking_rl_torch.rl.rollout import obs_to_model
    head = model.player0.policy
    obs = obs_to_model(obs_stack)[:, 0]
    h = torch.zeros((obs.shape[0], model.cfg.rnn_out), device=obs.device)
    scale = 1.0
    with torch.no_grad():
        while True:
            log_p = torch.log_softmax(model.tracker_fwd(obs, h, h).logits, -1)
            entropy = float(-(log_p.exp() * log_p).sum(-1).mean())
            if entropy < limit:
                return scale, entropy
            if scale > 2 ** 20:
                raise AssertionError(f"the tracker's entropy stays at "
                                     f"{entropy} under a scale of {scale}")
            head.weight.mul_(2)
            head.bias.mul_(2)
            scale *= 2


def _worst_by_family(got, want, layer_scale=False):
    """Per family of tensors (a layer: a name less its last part), the
    largest of max|got - want| / scale over its tensors, the scale being
    each tensor's largest entry in `want` or, with `layer_scale`, the
    largest over the layer's tensors."""
    scales, out = {}, {}
    for name, w in want.items():
        family = name.rsplit(".", 1)[0]
        scale = float(w.abs().max())
        scales[name] = scale
        scales[family] = max(scales.get(family, 0.0), scale)
    for name, w in want.items():
        family = name.rsplit(".", 1)[0]
        scale = scales[family if layer_scale else name]
        diff = float((got[name] - w).abs().max())
        out[family] = max(out.get(family, 0.0),
                          diff / scale if scale > 0 else diff)
    return out


#: a relu decision that the card and the CPU take apart must be a tie of
#: rounding: its pre-activation within this much of its tensor's largest
#: |pre-activation| (a float32 sum of K terms reordered moves by up to
#: K eps of their magnitudes, ~3e-5 for the encoder's K <= 512), and such
#: flips at most RELU_FLIP_SHARE of the decisions
RELU_TIE, RELU_FLIP_SHARE = 1e-4, 1e-6


class ReluDecisions:
    """Forward hooks on each conv and fc whose output an encoder relus
    (models/encoders.py): on the card's run they record each output's
    signs; on the CPU's, where a sign differs from the card's, they give
    the pre-activation the card's sign (the same magnitude, the gradient
    passing through unchanged), so that both runs route each gradient
    alike, and count those flips."""

    def __init__(self, torch):
        self.torch = torch
        self.signs, self.replay, self.calls = [], False, 0
        self.flips = self.decisions = 0
        self.worst = 0.0
        self.handles = []

    def attach(self, model, replay):
        from active_tracking_rl_torch.models import encoders
        self.replay, self.calls = replay, 0
        for m in model.modules():
            if isinstance(m, encoders._StackedConvEncoder) and not m.empty:
                if m.pool or m.bf16:
                    raise AssertionError("ReluDecisions: relu after a pool "
                                         "or in bfloat16")
                layers = [getattr(m, f"conv{i}") for i in range(len(m.convs))]
                layers += [m.fc] if m.fc is not None else []
                self.handles += [layer.register_forward_hook(self._hook)
                                 for layer in layers]

    def detach(self):
        for h in self.handles:
            h.remove()
        self.handles = []
        if self.replay and self.calls != len(self.signs):
            raise AssertionError(f"ReluDecisions: {self.calls} relus on the "
                                 f"CPU, {len(self.signs)} on the card")

    def _hook(self, module, inputs, y):
        if not self.replay:
            self.signs.append((y > 0).cpu())
            return None
        card = self.signs[self.calls].to(y.device)
        self.calls += 1
        self.decisions += y.numel()
        flip = card != (y > 0)
        n = int(flip.sum())
        if not n:
            return None
        self.flips += n
        mag = y.detach().abs()
        self.worst = max(self.worst,
                         float(mag[flip].max() / mag.max().clamp_min(1e-30)))
        target = self.torch.where(card, mag.clamp_min(1e-30), -mag)
        return y + (target - y.detach()) * flip


def check_update(torch, num_envs, pool, gen_cpu, tracker=None,
                 low_entropy=False):
    """One train step of the K=16 Nav recipe's config as the trainer CLI
    builds it (tat-maze-lstm on Track2D-BlockPartialNav-v0, train mode 0,
    20 steps, remat on) at `num_envs` envs and a pool of `pool` rows, on
    the card and on the CPU from the same state (reset on the card and
    copied), parameters and noise: the env carry after the step equal, and
    the loss and every gradient (as the update used it, after the clip)
    within UPDATE_TOL of its tensor's largest entry, and every updated
    parameter tensor within UPDATE_TOL of its layer's largest entry; the
    CPU takes the card's relu decisions (ReluDecisions), each flip a tie of
    rounding (RELU_TIE) and the flips few (RELU_FLIP_SHARE). The
    parameters are a fresh model's from `gen_cpu`, with the tracker
    file `tracker` loaded over it if given; `low_entropy` sharpens the
    tracker first (sharpen_tracker). Returns the worst relative errors per
    tensor family of the gradients, the parameters and the updates (the
    parameters' changes, not held to the tolerance), the losses, the
    sharpening's scale and first-step entropy, the step's entropy, and the
    relu flips, decisions and worst flip's share of its scale."""
    from active_tracking_rl_torch import config as tconfig
    from active_tracking_rl_torch.envs import env as env_mod
    from active_tracking_rl_torch.models import dueling
    from active_tracking_rl_torch.rl import checkpoint, learner
    from active_tracking_rl_torch.rl.rollout import stack_fill
    from active_tracking_rl_torch.run import train as train_cli
    args = train_cli.build_argparser().parse_args(
        UPDATE_FLAGS + ["--num-envs", str(num_envs), "--reset-pool",
                        str(pool)])
    tcfg = train_cli.train_config_from_args(args)
    ncfg = train_cli.net_config_from_args(args, tcfg)
    assert tcfg.remat and tcfg.train_mode == 0 and ncfg.name == "tat-maze-lstm"
    ecfg = tconfig.parse_env_id(tcfg.env_id)
    n, k = num_envs, ncfg.stack_frames
    draws = env_mod.draw_reset(ecfg, n + pool, gen_cpu, "cpu")
    noise = learner.draw_step_noise(tcfg.num_steps, n, ecfg.num_actions,
                                    gen_cpu, "cpu")
    state, obs = env_mod.TrackEnv(ecfg, "cuda").reset(_to(draws, "cuda"))
    state, obs = state.map(lambda x: x.cpu()), obs.cpu()
    model = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                device="cpu", generator=gen_cpu)
    if tracker is not None:
        checkpoint.load_params(model, load_tracker=tracker)
    scale, entropy = 1.0, None
    if low_entropy:
        scale, entropy = sharpen_tracker(torch, model,
                                         stack_fill(obs[:n], k))
    params = {name: v.clone() for name, v in model.state_dict().items()}
    out, relus = {}, ReluDecisions(torch)
    for dev in ("cuda", "cpu"):
        env = env_mod.TrackEnv(ecfg, dev)
        s, o = state.map(lambda x: x.to(dev)), obs.to(dev)
        model = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                    device=dev)
        model.load_state_dict(params)
        relus.attach(model, replay=dev == "cpu")
        opt = learner.make_optimizer_for(model, tcfg)
        zeros = torch.zeros((n, 2, ncfg.rnn_out), device=dev)
        carry = learner.TrainCarry(s.map(lambda x: x[:n]),
                                   stack_fill(o[:n], k), zeros,
                                   zeros.clone(), None)
        step = learner.make_train_step(model, env, ncfg, tcfg, opt)
        carry, metrics, _ = step(
            carry, tcfg.train_mode,
            (s.map(lambda x: x[n:]), o[n:], learner.init_pool_ptr(device=dev)),
            learner.StepNoise(*(x.to(dev) for x in noise)))
        relus.detach()
        out[dev] = dict(
            carry=carry.env_state.map(lambda x: x.cpu()),
            loss=metrics.loss.item(), entropy=float(metrics.entropy[0]),
            grads={name: p.grad.cpu() for name, p in model.named_parameters()
                   if p.grad is not None},
            params={name: v.cpu() for name, v in model.state_dict().items()})
    cpu, card = out["cpu"], out["cuda"]
    _assert_state_close(torch, cpu["carry"], card["carry"], "update carry")
    if set(cpu["grads"]) != set(card["grads"]) or not cpu["grads"]:
        raise AssertionError(f"gradients of {sorted(card['grads'])} on the "
                             f"card, of {sorted(cpu['grads'])} on the CPU")
    # float32 on both sides with TF32 off: only reduction order differs
    if not abs(cpu["loss"] - card["loss"]) <= UPDATE_TOL * max(
            1.0, abs(cpu["loss"])):
        raise AssertionError(f"update loss cuda {card['loss']} != cpu "
                             f"{cpu['loss']}")
    # a parameter against its layer's scale: a bias that starts at 0 is
    # one update (~1e-3) after the step, and SharedAdam (eps 1e-3) turns an
    # absolute gradient difference d into an update difference of up to
    # 0.03 d whatever the element's own gradient, so the bias's own scale
    # measures the update, not the parameter
    worst = {"grads": _worst_by_family(card["grads"], cpu["grads"]),
             "params": _worst_by_family(card["params"], cpu["params"],
                                        layer_scale=True),
             "updates": _worst_by_family(
                 {name: v - params[name] for name, v in card["params"].items()},
                 {name: v - params[name] for name, v in cpu["params"].items()
                  if not torch.equal(v, params[name])})}
    res = dict(worst, loss=(card["loss"], cpu["loss"]), scale=scale,
               first_entropy=entropy,
               entropy=(card["entropy"], cpu["entropy"]),
               relu=(relus.flips, relus.decisions, relus.worst))
    bad = {f"{kind} {family}": err for kind in ("grads", "params")
           for family, err in worst[kind].items() if not err <= UPDATE_TOL}
    if not (relus.worst <= RELU_TIE
            and relus.flips <= RELU_FLIP_SHARE * relus.decisions):
        bad["relu flips"] = relus.flips
    if bad:
        raise AssertionError(f"update card vs CPU beyond {UPDATE_TOL} of "
                             f"scale: {bad}; {update_text(res)}")
    return res


def update_text(res) -> str:
    """check_update's result on one line: the worst relative error of each
    of the tracker's (player0's) families; the target's parameters are not
    trained at mode 0 and stay equal."""
    def fams(d):
        return ", ".join(f"{f[len('player0.'):]} {e:.2e}"
                         for f, e in sorted(d.items())
                         if f.startswith("player0."))
    first = ("" if res["first_entropy"] is None else
             f"policy head x{res['scale']:g}, first-step entropy "
             f"{res['first_entropy']:.4f}, ")
    return (f"{first}step entropy cuda {res['entropy'][0]:.4f} cpu "
            f"{res['entropy'][1]:.4f}; loss cuda {res['loss'][0]:.6f} cpu "
            f"{res['loss'][1]:.6f}; worst |cuda - cpu| / scale: grads "
            f"[{fams(res['grads'])}]; params (layer scale) "
            f"[{fams(res['params'])}]; updates [{fams(res['updates'])}]; "
            f"relu decisions the CPU took from the card {res['relu'][0]} of "
            f"{res['relu'][1]} (limit {RELU_FLIP_SHARE:g} of them), worst at "
            f"{res['relu'][2]:.2e} of its tensor's scale (limit "
            f"{RELU_TIE:g})")


def check_eval(torch, tconfig, env_mod, dueling, evaluate, gen_cpu,
               episodes=8, max_steps=60):
    """The greedy evaluator of the AD-VAT preset on its eval env, on the card
    and the CPU from the same reset draws and parameters: episode lengths
    equal, returns to 1e-5 (the card's rewards may differ in the last ulp).
    Returns the card's episode lengths."""
    tcfg = tconfig.preset(ADVAT_PRESET)
    ncfg = tconfig.net_config_for(tcfg)
    ecfg = tconfig.parse_env_id(tcfg.env_base)
    draws = env_mod.draw_reset(ecfg, episodes, gen_cpu, "cpu")
    params = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                 device="cpu", generator=gen_cpu).state_dict()
    out = {}
    for dev in ("cpu", "cuda"):
        model = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                    device=dev)
        model.load_state_dict(params)
        out[dev] = evaluate.evaluate(model, env_mod.TrackEnv(ecfg, dev), ncfg,
                                     episodes=episodes, max_steps=max_steps,
                                     draws=_to(draws, dev))
    if not np.array_equal(out["cpu"]["ep_lens"], out["cuda"]["ep_lens"]):
        raise AssertionError(f"evaluator episode lengths cuda "
                             f"{out['cuda']['ep_lens']} != cpu "
                             f"{out['cpu']['ep_lens']}")
    np.testing.assert_allclose(out["cuda"]["ep_returns"],
                               out["cpu"]["ep_returns"], rtol=1e-5, atol=1e-5)
    return out["cuda"]["ep_lens"]


def check_draws(torch):
    """ops/noise.py's generator drawing on the card and on the CPU from the
    same seeds: bits, uniforms, integers and permutations equal bit for
    bit, each device's Gumbel noise within GUMBEL_ULP ulp of max(|g|, 1)
    of float64's -log(-log u) of the same u, and so the card's within twice
    that of the CPU's; then, the same way, the draws of one K=16 Nav train
    step at the recipe's batch (1024 envs, 20 steps, from the trainer's
    carry generator) and of one 256-row Nav pool (from run/train.py's pool
    window generator). Returns the count of values compared, the worst
    card-against-CPU Gumbel difference and each device's worst against
    float64, in those ulps."""
    from active_tracking_rl_torch import config as tconfig
    from active_tracking_rl_torch.envs import env as env_mod
    from active_tracking_rl_torch.ops import noise
    from active_tracking_rl_torch.rl import learner
    from active_tracking_rl_torch.run import train as train_cli
    tally = {"values": 0, "gumbel_ulp": 0.0, "gumbel_ulp_cuda": 0.0,
             "gumbel_ulp_cpu": 0.0}

    def ulps(got, want):
        """max |got - want| in float32 ulp of max(|want|, 1)."""
        want = want.double()
        ulp = torch.from_numpy(np.spacing(np.maximum(
            want.abs().cpu().numpy(), 1.0).astype(np.float32))).double()
        return float(((got.double().cpu() - want.cpu()).abs() / ulp).max())

    def same(got, want, what, gumbel=False):
        got = got.cpu()
        tally["values"] += want.numel()
        if not gumbel:
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"draws: {what} on the card != CPU")
            return
        worst = ulps(got, want)
        tally["gumbel_ulp"] = max(tally["gumbel_ulp"], worst)
        if not worst <= 2 * GUMBEL_ULP:
            raise AssertionError(f"draws: {what} Gumbel on the card differs "
                                 f"from the CPU's by {worst} ulp")

    real_gumbel = noise.gumbel

    def gumbel_held(shape, generator, device=None, rows=None, dim=0):
        """noise.gumbel, held to float64's -log(-log u) of its own u."""
        twin = noise.Threefry(generator.device).set_state(
            generator.get_state())
        g = real_gumbel(shape, generator, device, rows, dim)
        u = noise.uniform(shape, twin, device, rows=rows, dim=dim).double()
        worst = ulps(g, -torch.log(-torch.log(u.clamp_min_(noise._TINY))))
        key = f"gumbel_ulp_{g.device.type}"
        tally[key] = max(tally[key], worst)
        if not worst <= GUMBEL_ULP:
            raise AssertionError(f"draws: Gumbel {tuple(shape)} on "
                                 f"{g.device} is {worst} ulp from float64")
        return g

    noise.gumbel = gumbel_held
    try:
        _draws_both(torch, tconfig, env_mod, noise, learner, train_cli, same)
    finally:
        noise.gumbel = real_gumbel
    return tally


def _draws_both(torch, tconfig, env_mod, noise, learner, train_cli, same):
    """check_draws' draws on the card and on the CPU, each pair through
    `same`."""
    for seed in (0, 1, (5 << 32) + 3):
        gens = {d: noise.generator(seed, d) for d in ("cuda", "cpu")}
        out = {d: [noise.bits((1000003,), g, d),
                   noise.uniform((517, 33), g, d),
                   noise.uniform((64, 64), g, d, -0.0883, 0.0883),
                   noise.randint(6724, (256, 16), g, d),
                   noise.randint(6, (999,), g, d, torch.int8),
                   noise.permutations(256, 6400, g, d),
                   noise.gumbel((16, 15, 6724), g, d)]
               for d, g in gens.items()}
        for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
            same(a, b, f"seed {seed} draw {i}", gumbel=i == 6)
        if gens["cuda"].counter != gens["cpu"].counter:
            raise AssertionError("draws: the counters part")
    args = train_cli.build_argparser().parse_args(UPDATE_FLAGS)
    tcfg = train_cli.train_config_from_args(args)
    ecfg = tconfig.parse_env_id(tcfg.env_id)
    step = {d: learner.draw_step_noise(tcfg.num_steps, RECIPE_ENVS,
                                       ecfg.num_actions,
                                       noise.generator(tcfg.seed, d), d)
            for d in ("cuda", "cpu")}
    for name, a, b in zip(("actions", "bootstrap"), step["cuda"],
                          step["cpu"]):
        same(a, b, f"K=16 step {name}", gumbel=True)
    pools = {d: env_mod.TrackEnv(ecfg, d).draw_reset(
        256, train_cli.iteration_generator(tcfg.seed + train_cli.POOL_SEED,
                                           17, d))
        for d in ("cuda", "cpu")}

    def walk(a, b, what):
        if isinstance(b, torch.Tensor):
            same(a, b, what, gumbel=b.is_floating_point() and what.split(
                ".")[-2] in ("spawns", "nav"))
        elif dataclasses.is_dataclass(b):
            for f in dataclasses.fields(b):
                walk(getattr(a, f.name), getattr(b, f.name),
                     f"{what}.{f.name}")

    walk(pools["cuda"], pools["cpu"], "pool")


def phase_reference(torch, tconfig, env_mod, learner, dueling, evaluate,
                    gen_cpu):
    """The port on the card against the port on the CPU, small inputs."""
    t0 = time.perf_counter()
    losses = {}
    for env_id, mode in ((BENCH_ENV, 0), ("Track2D-MazeFullRPF-v0", 0),
                         (tconfig.preset(ADVAT_PRESET).env_id, -1)):
        losses[env_id] = check_train_step(
            torch, tconfig, env_mod, learner, dueling, env_id, mode, gen_cpu)
    # the other networks and SharedRMSprop
    for env_id, mode, network, optimizer in REFERENCE_NETS:
        losses[f"{env_id} {network} {optimizer}"] = check_train_step(
            torch, tconfig, env_mod, learner, dueling, env_id, mode, gen_cpu,
            network, optimizer)
    ids = [i for i in tconfig.env_ids() if i.endswith("-v0")]
    configs = [(i, tconfig.parse_env_id(i)) for i in ids]
    configs.append(("Moore Track2D-BlockPartialRam-v0", dataclasses.replace(
        tconfig.parse_env_id("Track2D-BlockPartialRam-v0"),
        action_type="Moore")))
    configs.append(("Track2D-MazePartialRPF-v0 pallas", dataclasses.replace(
        tconfig.parse_env_id("Track2D-MazePartialRPF-v0"),
        flood_backend="pallas")))
    for what, ecfg in configs:
        check_reset_steps(torch, env_mod, ecfg, gen_cpu, REFERENCE_ROWS, what)
    eval_lens = check_eval(torch, tconfig, env_mod, dueling, evaluate,
                           gen_cpu)
    draws = check_draws(torch)
    updates = {what: check_update(torch, UPDATE_ENVS, UPDATE_POOL, gen_cpu,
                                  low_entropy=low)
               for what, low in (("fresh", False), ("low-entropy", True))}
    loss_text = "; ".join(
        f"{k} loss cuda {lg:.6f} vs cpu {lc:.6f}, pred_loss cuda {pg:.6f} "
        f"vs cpu {pc:.6f}" for k, ((lg, lc), (pg, pc)) in losses.items())
    say("reference", t0, f"ops/noise.py's draws cuda vs cpu: "
        f"{draws['values']} values (bits, uniforms, integers, "
        f"permutations, a K=16 step's noise, a 256-row Nav pool's draws) "
        f"equal, Gumbel within {draws['gumbel_ulp_cuda']:g} (card) and "
        f"{draws['gumbel_ulp_cpu']:g} (CPU) ulp of max(|g|, 1) of float64's "
        f"-log(-log u) (limit {GUMBEL_ULP}), card vs CPU "
        f"{draws['gumbel_ulp']:g} ulp; reset + 3 steps bit-exact cuda vs cpu for "
        f"{len(configs)} configs ({len(ids)} level-0 ids, Moore, RPF on "
        f"flood_relax) at {REFERENCE_ROWS} rows; 8-step train step: "
        f"{loss_text}; greedy evaluator, {len(eval_lens)} episodes of 60 "
        f"steps: lengths {eval_lens.tolist()} equal, returns to 1e-5; "
        f"K=16 Nav update (remat on) at {UPDATE_ENVS} envs, pool "
        f"{UPDATE_POOL}, every gradient and updated parameter to "
        f"{UPDATE_TOL:g} of its tensor's or layer's scale: " + "; ".join(
            f"{what}: {update_text(res)}" for what, res in updates.items()))


def reset_counts(flood) -> None:
    for kernel in flood.KERNELS.values():
        kernel.launches = 0


def phase_main(torch, flood, bench, profile_iter, learner, name, env_id,
               flood_backend, must_launch, must_not_launch):
    """A trainer's path at full width, timed through run/bench.py's loop;
    returns the timed steps' launches."""
    t0 = time.perf_counter()
    b = bench.build_bench(num_envs=NUM_ENVS, num_steps=NUM_STEPS,
                          env_id=env_id, network="maze-lstm", train_mode=0,
                          remat=False, device="cuda",
                          flood_backend=flood_backend)
    if b.tcfg.reset_pool != RESET_POOL:
        raise AssertionError(f"{name}: bench's pool {b.tcfg.reset_pool}")
    torch.cuda.synchronize()
    say(f"{name}-init", t0, f"init_learner at {NUM_ENVS} envs, {env_id}, "
        f"flood_backend {b.env.cfg.flood_backend!r}")

    # one untimed step: the first at these shapes grows the allocator and
    # picks the cuDNN and cuBLAS algorithms
    reset_counts(flood)
    tw = time.perf_counter()
    b.iterate(0)
    torch.cuda.synchronize()
    say(f"{name}-warm-up", tw, "one train step, not timed")
    res = bench.time_bench(b, TRAIN_STEPS, warmup=0)
    launches, total = res.launches, flood.launches()
    # the warm-up step launched what a timed step launches
    if any(total[k] * TRAIN_STEPS != launches[k] * (TRAIN_STEPS + 1)
           for k in total):
        raise AssertionError(f"{name}: {total} launched in all, "
                             f"{launches} in the timed steps")
    if res.iters != TRAIN_STEPS or not all(np.isfinite(res.losses)):
        raise AssertionError(f"{name}: {res.iters} steps, losses "
                             f"{res.losses}")
    if launches[must_launch] == 0:
        raise AssertionError(f"{name} never launched {must_launch}")
    for other in must_not_launch:
        if launches[other] != 0:
            raise AssertionError(f"{name} launched {other} "
                                 f"{launches[other]} times")
    if (res.remat, res.precision) != (False, "fp32"):
        raise AssertionError(f"{name} ran remat {res.remat}, "
                             f"{res.precision}")
    say(name, t0, f"{TRAIN_STEPS} train steps (run/bench.py, remat off, "
        f"{res.precision}) in {res.seconds:.3f} s: "
        f"{res.env_steps_per_s:.1f} env-steps/s; launches {launches} "
        f"({launches[must_launch] / TRAIN_STEPS:g} {must_launch} per "
        f"iteration); losses {res.losses}; "
        f"peak {res.peak_bytes / 2**30:.2f} GiB")

    # where an iteration's time goes: the pool, then a step on that pool
    pool_fn = learner.make_pool_fn(b.env, b.tcfg)
    t2 = time.perf_counter()
    pool = pool_fn(b.generator)
    torch.cuda.synchronize()
    say(f"{name}-pool", t2, f"one reset pool of {RESET_POOL} rows "
        "(map, spawns, floods, 512-tick tapes)")
    # the pool's parts, in reset's order, on fresh draws (run/profile_iter.py)
    t3 = time.perf_counter()
    parts = profile_iter.pool_parts(b.env, RESET_POOL, b.generator, iters=1,
                                    warmup=0)
    say(f"{name}-pool-parts", t3, "; ".join(
        f"{k} {v:.3f} s" for k, v in parts.items()) + " (tape: floods, "
        "512 ticks)")
    t3 = time.perf_counter()
    b.train_step(b.carry, b.mode, (*pool, learner.init_pool_ptr(device="cuda")))
    torch.cuda.synchronize()
    say(f"{name}-step", t3, "one train step on that pool (rollout, loss, "
        "backward, SharedAdam)")
    return launches, b


def _train_state(train_cli, model, opt, carry, metrics=None):
    """A copy of the parameters, the optimizer state, the carry (with its
    generator's state) and, if given, a step's metrics."""
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "carry": train_cli.carry_state(carry)}
    if metrics is not None:
        state["metrics"] = dict(zip(metrics._fields, metrics))
    return copy.deepcopy(state)


def phase_repro(torch, train_cli, b):
    """The main path's train step twice from one state (a fresh pool drawn
    inside each): parameters, optimizer state, carry and metrics equal bit
    for bit."""
    t0 = time.perf_counter()
    start = _train_state(train_cli, b.model, b.opt, b.carry)
    ends = []
    for _ in range(2):
        b.model.load_state_dict(start["model"])
        b.opt.load_state_dict(copy.deepcopy(start["optimizer"]))
        b.carry = train_cli.restore_carry(copy.deepcopy(start["carry"]),
                                          b.carry.generator)
        m = b.iterate(0)
        ends.append(_train_state(train_cli, b.model, b.opt, b.carry, m))
    torch.cuda.synchronize()
    _assert_tensors_equal(torch, ends[1], ends[0], "repro")
    if all(torch.equal(ends[0]["model"][k], v)
           for k, v in start["model"].items()):
        raise AssertionError("repro: the step left every parameter as it "
                             "was")
    say("repro", t0, f"the main path's train step twice from one state at "
        f"{b.tcfg.num_envs} envs: parameters, optimizer state, carry and "
        f"metrics equal bit for bit (loss "
        f"{float(ends[0]['metrics']['loss']):.6f})")


def phase_bench_flood(torch, flood, bench_flood):
    """run/bench_flood.py at BENCH_FLOOD_ROWS rows: every backend's time on
    Block and Maze maps; both kernels' fields must be equal."""
    t0 = time.perf_counter()
    reset_counts(flood)
    out = bench_flood.bench_flood(rows=BENCH_FLOOD_ROWS, device="cuda",
                                  iters=BENCH_FLOOD_ITERS, warmup=1)
    launches = flood.launches()
    keys = {f"{m}PartialNav_{b}" for m in ("Block", "Maze")
            for b in ("xla_s", "pallas_s", "pallas_sweep_s",
                      "sweep_equals_relax")}
    if set(out) != keys or not all(out[f"{m}PartialNav_sweep_equals_relax"]
                                   is True for m in ("Block", "Maze")):
        raise AssertionError(f"bench-flood: {out}")
    # per map family: (warmup + iters) calls of each kernel backend, and
    # the check's one call of each
    per = 2 * (1 + BENCH_FLOOD_ITERS + 1)
    if launches != {"flood_sweep": per, "flood_sweep16": 0,
                    "flood_relax": per}:
        raise AssertionError(f"bench-flood launched {launches}")
    say("bench-flood", t0, f"{BENCH_FLOOD_ROWS} rows x 16 goals: " + "; ".join(
        f"{k} {v * 1e3:.3f} ms" if isinstance(v, float) else f"{k} {v}"
        for k, v in out.items()) + f"; launches {launches}")
    return launches


def phase_advat(torch, flood, tconfig, env_mod, learner, dueling,
                curriculum):
    """AD-VAT's trainer at full width; returns the trained model, its net
    and train configs, and the timed steps' launches."""
    t0 = time.perf_counter()
    tcfg = dataclasses.replace(
        tconfig.preset(ADVAT_PRESET), num_envs=NUM_ENVS,
        reset_pool=RESET_POOL, num_steps=NUM_STEPS,
        init_step=ADVAT_INIT_STEP)
    ncfg = tconfig.net_config_for(tcfg)
    ecfg = tconfig.parse_env_id(tcfg.env_id)
    if not (ncfg.tat and ncfg.aux_reward) or tcfg.train_mode != -1:
        raise AssertionError(f"advat runs {ncfg.name} at train mode "
                             f"{tcfg.train_mode}")
    env = env_mod.TrackEnv(ecfg, "cuda")
    model = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                device="cuda")
    gen = draw_gen(1, "cuda")
    state = learner.init_learner(model, env, ncfg, tcfg, gen)
    step = learner.make_train_step(model, env, ncfg, tcfg, state.opt)
    cur = curriculum.CurriculumState.initial(tcfg)
    torch.cuda.synchronize()
    say("advat-init", t0, f"init_learner at {NUM_ENVS} envs, {tcfg.env_id}, "
        f"{ncfg.name}, train mode {tcfg.train_mode}, init_step "
        f"{tcfg.init_step}, entropy_target {tcfg.entropy_target}, amsgrad "
        f"{tcfg.amsgrad}")

    tw = time.perf_counter()
    cur = curriculum.update(tcfg, cur, 1)
    carry, _, _ = step(state.carry, cur.mode)
    torch.cuda.synchronize()
    say("advat-warm-up", tw, f"iteration 1 at mode {cur.mode}, not timed")

    torch.cuda.reset_peak_memory_stats()
    reset_counts(flood)
    modes, secs, metrics = [], [], []
    for it in range(2, 2 + TRAIN_STEPS):
        cur = curriculum.update(tcfg, cur, it)
        t1 = time.perf_counter()
        carry, m, _ = step(carry, cur.mode)      # a fresh pool each
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        modes.append(cur.mode)
        metrics.append(m)
    launches = flood.launches()
    if sum(launches.values()) != 0:
        raise AssertionError(f"advat launched flood kernels: {launches}")
    if modes[0] != 0 or modes[-1] != -1:
        raise AssertionError(f"advat's timed modes {modes} do not cross "
                             f"from 0 to -1")
    losses, preds = [], []
    for mode, m in zip(modes, metrics):
        loss, pred = m.loss.item(), m.pred_loss.item()
        players = (m.policy_loss + 0.5 * m.value_loss).tolist()
        rest = loss - players[0] - (players[1] if mode else 0.0)
        want = pred if mode else 0.0
        scale = abs(loss) + sum(abs(x) for x in players) + abs(pred)
        if not (np.isfinite([loss, pred]).all() and pred > 0
                and abs(rest - want) <= 1e-4 * max(1.0, scale)):
            raise AssertionError(f"advat mode {mode}: loss {loss} = players "
                                 f"{players} + {rest}, pred_loss {pred}")
        losses.append(loss)
        preds.append(pred)
    dt = sum(secs)
    sps = TRAIN_STEPS * NUM_ENVS * NUM_STEPS / dt
    say("advat", t0, f"{TRAIN_STEPS} train steps in {dt:.3f} s: {sps:.1f} "
        f"env-steps/s; step seconds {[round(x, 4) for x in secs]}; modes "
        f"{modes}; losses {losses}; pred_losses {preds} (in the loss at "
        f"mode -1 only); launches {launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # where an iteration's time goes: the pool, then a step on that pool
    t2 = time.perf_counter()
    pool = learner.make_pool_fn(env, tcfg)(gen)
    torch.cuda.synchronize()
    say("advat-pool", t2, f"one reset pool of {RESET_POOL} rows (map, "
        "spawns, zero tapes)")
    t3 = time.perf_counter()
    step(carry, cur.mode, (*pool, learner.init_pool_ptr(device="cuda")))
    torch.cuda.synchronize()
    say("advat-step", t3, f"one train step on that pool at mode {cur.mode} "
        "(rollout, loss, backward, SharedAdam)")
    return model, ncfg, tcfg, launches


def phase_advat_eval(torch, flood, tconfig, env_mod, evaluate, model, ncfg,
                     tcfg):
    """The greedy evaluator with advat's trained players on the preset's
    eval env; returns its launches."""
    t0 = time.perf_counter()
    env = env_mod.TrackEnv(tconfig.parse_env_id(tcfg.env_base), "cuda")
    gen = draw_gen(2, "cuda")
    reset_counts(flood)
    out = evaluate.evaluate(model, env, ncfg, gen, EVAL_EPISODES, EVAL_STEPS)
    dt = time.perf_counter() - t0
    launches = flood.launches()
    if launches["flood_sweep"] == 0 or sum(launches.values()) \
            != launches["flood_sweep"]:
        raise AssertionError(f"advat-eval launched {launches}")
    lens = out["ep_lens"]
    if out["ep_returns"].shape != (EVAL_EPISODES, 2) \
            or not np.isfinite(out["ep_returns"]).all() \
            or lens.min() < 1 or lens.max() > EVAL_STEPS \
            or not np.isclose(out["S_rate"], (lens >= EVAL_STEPS).mean()):
        raise AssertionError(f"advat-eval gave {out}")
    say("advat-eval", t0, f"{EVAL_EPISODES} episodes x {EVAL_STEPS} greedy "
        f"steps on {tcfg.env_base} in {dt:.3f} s: S_rate "
        f"{float(out['S_rate']):.2f}, EL_mean {float(out['EL_mean']):.2f}, "
        f"R_mean {out['R_mean'].tolist()}; launches {launches}")
    return launches


def phase_sweep16_entry(torch, flood, mz, goals):
    """flood_fields(variant="sweep16"), the int16 variant's only entry point
    (as flood_fields_pallas(variant="sweep16") is in the JAX package), on one
    main-path pool's mazes and goals."""
    t0 = time.perf_counter()
    iters = 256
    reset_counts(flood)
    out = flood.flood_fields(mz, goals, iters, "sweep16")
    torch.cuda.synchronize()
    launches = flood.launches()
    if launches["flood_sweep16"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"sweep16 entry launched {launches}")
    if out.shape != (*goals.shape[:2], *mz.shape[1:]):
        raise AssertionError(f"sweep16 entry gave shape {tuple(out.shape)}")
    say("sweep16-entry", t0, f"flood_fields(variant='sweep16') on "
        f"{mz.shape[0]}x{goals.shape[1]} fields; launches {launches}")
    return launches


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _log_lines(run_dir, *starts):
    """The trainer's log lines (after the time stamp) that start with one of
    `starts`."""
    with open(pathlib.Path(run_dir) / "logger") as f:
        lines = [line.rstrip("\n").split(" : ", 1)[-1] for line in f]
    return [line for line in lines if line.startswith(starts)]


def _assert_tensors_equal(torch, got, want, what):
    """Nested dicts and lists of tensors and numbers, equal bit for bit."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{what}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        for k in want:
            _assert_tensors_equal(torch, got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{what}: length {len(got)} != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tensors_equal(torch, g, w, f"{what}/{i}")
    elif torch.is_tensor(want):
        if got.dtype != want.dtype or not torch.equal(got.to(want.device),
                                                      want):
            raise AssertionError(f"{what} differs")
    elif got != want:
        raise AssertionError(f"{what}: {got} != {want}")


def phase_cli_train(torch, flood, train_cli, tmp):
    """The trainer CLI at AD-VAT's defaults on the card; returns its session
    and launches."""
    t0 = time.perf_counter()
    reset_counts(flood)
    s = train_cli.main(CLI_TRAIN_FLAGS + ["--log-dir", str(tmp)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flood.launches()
    tcfg, ncfg = s.tcfg, s.ncfg
    if (tcfg.env_id, tcfg.env_base, ncfg.name, tcfg.train_mode,
            tcfg.remat) != ("Track2D-BlockPartialPZR-v0",
                            "Track2D-BlockPartialNav-v0", "tat-maze-lstm", -1,
                            True):
        raise AssertionError(f"cli-train ran {tcfg} {ncfg}")
    rows = _read_jsonl(pathlib.Path(s.run_dir) / "metrics.jsonl")
    train_steps = [r["step"] for r in rows if "train/policy_loss_0" in r]
    test = {r["step"]: r for r in rows if "test/success_rate" in r}
    if train_steps != [1] or sorted(test) != [3, 6]:
        raise AssertionError(f"cli-train logged train {train_steps}, test "
                             f"{sorted(test)}")
    if not all(np.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"cli-train logged non-finite scalars: {rows}")
    files = sorted(p.name for p in pathlib.Path(s.run_dir).iterdir())
    for name in ("train_state.pt", "ckpt_meta.json", "all-best-3.msgpack",
                 "tracker-best.msgpack", "target-best.msgpack"):
        if name not in files:
            raise AssertionError(f"cli-train wrote no {name}: {files}")
    with open(pathlib.Path(s.run_dir) / "ckpt_meta.json") as f:
        meta = json.load(f)
    if meta["n_iter"] != 6:
        raise AssertionError(f"cli-train's ckpt_meta.json: {meta}")
    if launches["flood_sweep"] != 2 or sum(launches.values()) != 2:
        raise AssertionError(f"cli-train launched {launches} (want "
                             f"flood_sweep once per eval reset)")
    for line in _log_lines(s.run_dir, "iter ", "eval "):
        say("cli-train", t0, line)
    say("cli-train", t0, f"6 iterations at {tcfg.num_envs} envs and 2 evals "
        f"of {tcfg.test_eps} x 500 steps in {dt:.3f} s ("
        f"{6 * tcfg.num_envs * tcfg.num_steps / dt:.1f} env-steps/s over the "
        f"whole run); every iteration's metrics finite (--debug-nans); "
        f"files {files}; launches {launches}")
    return s, launches


def phase_cli_resume(torch, flood, train_cli, checkpoint, first, tmp):
    """--resume of cli-train's run: the loaded state is what was saved, bit
    for bit, before it steps on to iteration 8."""
    t0 = time.perf_counter()
    reset_counts(flood)
    s = train_cli.setup(CLI_TRAIN_FLAGS + [
        "--log-dir", str(tmp), "--run-name", "smoke-resume",
        "--total-iters", "8", "--resume", first.run_dir])
    saved = checkpoint.load_train_state(first.run_dir, map_location="cuda")
    _assert_tensors_equal(torch, s.model.state_dict(), saved["model"],
                          "model")
    _assert_tensors_equal(torch, s.opt.state_dict(), saved["optimizer"],
                          "optimizer")
    _assert_tensors_equal(torch, train_cli.carry_state(s.carry),
                          saved["carry"], "carry")
    # ... which is the state the first run ended with
    _assert_tensors_equal(torch, s.model.state_dict(),
                          first.model.state_dict(), "model vs live")
    _assert_tensors_equal(torch, s.opt.state_dict(), first.opt.state_dict(),
                          "optimizer vs live")
    _assert_tensors_equal(torch, train_cli.carry_state(s.carry),
                          train_cli.carry_state(first.carry), "carry vs live")
    if (s.start_iter, s.cur, s.ckpt.max_score) != (
            6, first.cur, first.ckpt.max_score):
        raise AssertionError(f"cli-resume starts after {s.start_iter} at "
                             f"{s.cur}, watermark {s.ckpt.max_score}")
    try:
        s = train_cli.run(s)
    finally:
        train_cli.close_logger(s.log)
    torch.cuda.synchronize()
    launches = flood.launches()
    with open(pathlib.Path(s.run_dir) / "ckpt_meta.json") as f:
        meta = json.load(f)
    if meta["n_iter"] != 8 or launches["flood_sweep"] != 1 \
            or sum(launches.values()) != 1:
        raise AssertionError(f"cli-resume: {meta}, launches {launches}")
    for line in _log_lines(s.run_dir, "resumed", "eval "):
        say("cli-resume", t0, line)
    # the resumed run ends where one uninterrupted run of 8 iterations does
    t1 = time.perf_counter()
    straight = train_cli.main(CLI_TRAIN_FLAGS + [
        "--log-dir", str(tmp), "--run-name", "smoke-straight",
        "--total-iters", "8", "--checkpoint-every", "8"])
    torch.cuda.synchronize()
    _assert_tensors_equal(
        torch, _train_state(train_cli, s.model, s.opt, s.carry),
        _train_state(train_cli, straight.model, straight.opt, straight.carry),
        "resumed vs uninterrupted at iteration 8")
    evals = [{k: v for k, v in r.items() if k.startswith("test/")}
             for run in (s, straight) for r in
             _read_jsonl(pathlib.Path(run.run_dir) / "metrics.jsonl")
             if r["step"] == 8 and "test/success_rate" in r]
    if len(evals) != 2 or evals[0] != evals[1]:
        raise AssertionError(f"cli-resume: the evals at 8 differ: {evals}")
    say("cli-resume", t0, f"params, optimizer state, carry and generator "
        f"state loaded bit for bit; iterations 7-8 at mode {s.cur.mode}, "
        f"watermark {first.ckpt.max_score:.3f}; launches {launches}; at "
        f"iteration 8 equal bit for bit to an uninterrupted run of 8 "
        f"({time.perf_counter() - t1:.3f} s), eval {evals[0]}")
    return launches


def phase_cli_eval(torch, flood, tconfig, env_mod, dueling, evaluate,
                   checkpoint, eval_cli, eval_matrix, run_dir, tmp):
    """run/eval.py and run/eval_matrix.py on cli-train's parameter files;
    eval.py against rl/evaluate.py in this process."""
    t0 = time.perf_counter()
    env_id = "Track2D-BlockPartialNav-v0"
    tracker = str(pathlib.Path(run_dir) / "tracker-best.msgpack")
    target = str(pathlib.Path(run_dir) / "target-best.msgpack")
    reset_counts(flood)
    got = eval_cli.main(["--env", env_id, "--load-tracker", tracker,
                         "--load-target", target, "--num-episodes",
                         str(EVAL_EPISODES), "--log-dir", str(tmp)])
    dt = time.perf_counter() - t0
    ncfg = tconfig.NetConfig.from_name("tat-maze-lstm")
    ecfg = tconfig.parse_env_id(env_id)
    model = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                device="cuda",
                                generator=draw_gen(1, "cuda"))
    checkpoint.load_params(model, None, tracker, target)
    want = evaluate.evaluate(model, env_mod.TrackEnv(ecfg, "cuda"), ncfg,
                             draw_gen(1, "cuda"),
                             EVAL_EPISODES)
    if got["S_rate"] != want["S_rate"] or got["EL_mean"] != want["EL_mean"]:
        raise AssertionError(f"eval.py S_rate {got['S_rate']} EL_mean "
                             f"{got['EL_mean']} != rl/evaluate.py "
                             f"{want['S_rate']} {want['EL_mean']}")
    np.testing.assert_allclose(got["R_mean"], want["R_mean"], rtol=1e-5,
                               atol=1e-5)
    say("cli-eval", t0, f"run/eval.py, {EVAL_EPISODES} episodes on {env_id} "
        f"in {dt:.3f} s: S_rate {float(got['S_rate']):.2f}, EL_mean "
        f"{float(got['EL_mean']):.2f}, R_mean {got['R_mean'].tolist()} == "
        f"rl/evaluate.py's (R_mean to 1e-5)")
    t1 = time.perf_counter()
    out = pathlib.Path(tmp) / "matrix.json"
    matrix = eval_matrix.main(["--tracker", f"smoke={tracker}", "--env",
                               env_id, "--num-episodes", str(EVAL_EPISODES),
                               "--eval-seeds", "2", "--out", str(out)])
    row = matrix[env_id]["smoke"]
    if json.loads(out.read_text())[env_id]["smoke"]["S_ci95"] != \
            row["S_ci95"] or row["episodes"] != 2 * EVAL_EPISODES:
        raise AssertionError(f"eval_matrix wrote {row}")
    launches = flood.launches()
    if launches["flood_sweep"] != 4 or sum(launches.values()) != 4:
        raise AssertionError(f"cli-eval launched {launches}")
    say("cli-eval", t1, f"run/eval_matrix.py, 2 seeds x {EVAL_EPISODES} "
        f"episodes: S_rate {row['S_rate']} (Wilson 95% {row['S_ci95']}), "
        f"R_mean {row['R_mean']} +- {row['R_ci95']}; launches {launches}")
    return launches


def _grads_of_one_step(torch, learner, optim, s, remat, pool, noise, state):
    """The gradients of one train step of session `s`'s model from `state`
    (parameters) and its carry, with remat on or off."""
    import copy
    model = copy.deepcopy(s.model)
    model.load_state_dict(state)
    tcfg = dataclasses.replace(s.tcfg, remat=remat, lr=0.0)
    opt = optim.make_optimizer_for(model, tcfg)
    c = s.carry
    carry = learner.TrainCarry(c.env_state.map(lambda x: x.clone()),
                               c.obs_stack.clone(), c.hx.clone(),
                               c.cx.clone(), None)
    step = learner.make_train_step(model, s.env, s.ncfg, tcfg, opt)
    _, m, _ = step(carry, s.tcfg.train_mode,
                   (*pool, learner.init_pool_ptr(device="cuda")), noise)
    return m, {n: p.grad.clone() for n, p in model.named_parameters()
               if p.grad is not None}


def phase_cli_nets(torch, flood, train_cli, learner, optim, tmp):
    """The CLI with every other network family, RMSprop, bf16 and no remat;
    then one step's gradients with and without remat from one state."""
    t0 = time.perf_counter()
    reset_counts(flood)
    for i, flags in enumerate(CLI_NETS):
        t1 = time.perf_counter()
        s = train_cli.main(flags + CLI_NETS_FLAGS + [
            "--log-dir", str(tmp), "--run-name", f"nets{i}"])
        torch.cuda.synchronize()
        rows = _read_jsonl(pathlib.Path(s.run_dir) / "metrics.jsonl")
        if not all(np.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"cli-nets {flags}: {rows}")
        ev = _log_lines(s.run_dir, "eval ")
        say("cli-nets", t1, f"{s.ncfg.name} (bf16 {s.ncfg.bf16}, remat "
            f"{s.tcfg.remat}, {s.tcfg.optimizer}) on {s.tcfg.env_id}, train "
            f"mode {s.tcfg.train_mode}: 2 iterations at {s.tcfg.num_envs} "
            f"envs, losses finite (--debug-nans), loss at iteration 1 "
            f"{float(s.last_metrics['loss']):.6f}; {ev[-1]}")
    launches = flood.launches()

    # the last run's (tat-maze-lstm, --no-remat) state
    t2 = time.perf_counter()
    gen = draw_gen(5, "cuda")
    pool = learner.make_pool_fn(s.env, s.tcfg)(gen)
    noise = learner.draw_step_noise(s.tcfg.num_steps, s.tcfg.num_envs,
                                    s.env.num_actions, gen, "cuda")
    state = {k: v.clone() for k, v in s.model.state_dict().items()}
    m1, g1 = _grads_of_one_step(torch, learner, optim, s, True, pool, noise,
                                state)
    m0, g0 = _grads_of_one_step(torch, learner, optim, s, False, pool, noise,
                                state)
    if set(g1) != set(g0) or not g0:
        raise AssertionError("remat and no-remat steps have other grads")
    worst = 0.0
    for name in g0:
        scale = float(g0[name].abs().max().clamp_min(1e-30))
        err = float((g1[name] - g0[name]).abs().max()) / scale
        worst = max(worst, err)
        if err > 1e-5:
            raise AssertionError(f"remat grad {name} off by {err:.3g} "
                                 f"relative")
    say("cli-nets-remat", t2, f"one train step of {s.ncfg.name} at "
        f"{s.tcfg.num_envs} envs from one state: loss remat "
        f"{m1.loss.item():.6f} vs not {m0.loss.item():.6f}; grads agree to "
        f"{worst:.3g} relative (bound 1e-5)")
    say("cli-nets", t0, f"launches {launches}")
    return launches


def phase_learn(torch, flood, tconfig, env_mod, learner, dueling, evaluate):
    """tests/test_learning_smoke.py's bar on the card: LEARN_ITERS
    iterations of the Block-Ram tracker must lift the greedy eval return by
    > 30 and the episode length by > 20."""
    t0 = time.perf_counter()
    # remat off (TrainConfig's default), as that test runs it
    tcfg = tconfig.TrainConfig(env_id=LEARN_ENV, env_base=LEARN_ENV,
                               train_mode=0, num_envs=128, reset_pool=32,
                               num_steps=20, lr=3e-3)
    ncfg = tconfig.NetConfig.from_name("maze-lstm", aux="none")
    ecfg = dataclasses.replace(tconfig.parse_env_id(LEARN_ENV),
                               max_episode_steps=LEARN_STEPS, tape_len=128)
    env = env_mod.TrackEnv(ecfg, "cuda")
    model = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                device="cuda")
    reset_counts(flood)
    state = learner.init_learner(model, env, ncfg, tcfg,
                                 draw_gen(0, "cuda"))
    step = learner.make_train_step(model, env, ncfg, tcfg, state.opt)
    ev = evaluate.make_evaluator(model, env, ncfg, LEARN_EPISODES, LEARN_STEPS)
    before = ev(draw_gen(42, "cuda"))
    carry = state.carry
    t1 = time.perf_counter()
    for _ in range(LEARN_ITERS):
        carry, m, _ = step(carry, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    after = ev(draw_gen(42, "cuda"))
    launches = flood.launches()
    r0, r1 = float(before["R_mean"][0]), float(after["R_mean"][0])
    l0, l1 = float(before["EL_mean"]), float(after["EL_mean"])
    if not (np.isfinite(m.loss.item()) and r1 > r0 + 30 and l1 > l0 + 20):
        raise AssertionError(f"learn: R0 {r0} -> {r1}, EL_mean {l0} -> {l1}")
    say("learn", t0, f"{LEARN_ITERS} iterations of maze-lstm on {LEARN_ENV} "
        f"({tcfg.num_envs} envs, {LEARN_STEPS}-step episodes) in {dt:.3f} s "
        f"({LEARN_ITERS * tcfg.num_envs * tcfg.num_steps / dt:.1f} "
        f"env-steps/s): R0 {r0:.2f} -> {r1:.2f} (bar +30), EL_mean {l0:.2f} "
        f"-> {l1:.2f} (bar +20); launches {launches}")
    return launches


# --- the host-env trainer's paths ------------------------------------------


class ToyImageEnv:
    """A single-agent env (tests/test_host_loop.py's): random (1, 1, 1, 13,
    13) obs, reward 1 for action 0, episodes of 10 steps."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.t = 0

    def _obs(self):
        return self.rng.rand(1, 1, 1, 13, 13).astype(np.float32)

    def reset(self):
        self.t = 0
        return self._obs()

    def step(self, action):
        self.t += 1
        r = np.array([1.0 if int(np.asarray(action).ravel()[0]) == 0
                      else 0.0], np.float32)
        return self._obs(), r, self.t >= 10, {}


class DirectionPool:
    """The continuous-action pool of tests/test_continuous.py (a numpy
    copy): a 13 x 13 one-hot image marks a per-episode unit direction d;
    actions are 2-d in the box [-2, 2]; the tracker's reward is
    (a . d) / 2 per step (with `players` 2 the target's is its negative);
    episodes last 16 steps."""

    EP_LEN = 16

    def __init__(self, batch: int, seed: int = 0, players: int = 1):
        self.B, self.players = batch, players
        self.rng = np.random.default_rng(seed)
        self.t = np.zeros(batch, np.int64)
        self.dir = np.zeros((batch, 2), np.float32)

    def __len__(self):
        return self.B

    def _redraw(self, rows):
        ang = self.rng.uniform(0, 2 * np.pi, size=rows.sum())
        self.dir[rows] = np.stack([np.cos(ang), np.sin(ang)], -1)
        self.t[rows] = 0

    def _obs(self):
        img = np.zeros((self.B, self.players, 1, 13, 13), np.float32)
        px = 6 + np.round(4 * self.dir).astype(int)
        img[np.arange(self.B), :, 0, px[:, 0], px[:, 1]] = 1.0
        return img

    def reset(self):
        self._redraw(np.ones(self.B, bool))
        return self._obs()

    def step(self, actions):
        a = np.asarray(actions, np.float32)
        if self.players == 1:
            a = a.reshape(self.B, 1, 2)
        if np.abs(a).max() > 2.0 + 1e-5:
            raise AssertionError("actions outside the env's box")
        r0 = (a[:, 0] * self.dir).sum(-1) / 2.0
        self.t += 1
        done = self.t >= self.EP_LEN
        if done.any():
            self._redraw(done)
        r = r0[:, None] if self.players == 1 else np.stack([r0, -r0], -1)
        return self._obs(), r, done, {}


def check_gym_env(torch, bridge, env_mod, tconfig, env_id, gen_cpu,
                  steps=20):
    """GymTrackEnv on the card and on the CPU from the same reset draws and
    `steps` fixed actions: obs and done equal, rewards to 1e-6, the state's
    integers bit for bit and its floats to 1e-6."""
    from active_tracking_rl_torch.ops import noise
    ecfg = tconfig.parse_env_id(env_id)
    draws = env_mod.draw_reset(ecfg, 1, gen_cpu, "cpu")
    actions = noise.randint(ecfg.num_actions, (steps, 2), gen_cpu,
                            "cpu").numpy()
    out = {}
    for dev in ("cpu", "cuda"):
        env = bridge.GymTrackEnv(env_id, device=dev)
        trace = [(env.reset(_to(draws, dev)), None, None,
                  env._state.map(lambda x: x.cpu()))]
        for a in actions:
            obs, rew, done, _ = env.step(a)
            trace.append((obs, rew, done, env._state.map(lambda x: x.cpu())))
        out[dev] = trace
    for i, (c, g) in enumerate(zip(out["cpu"], out["cuda"])):
        if not (np.array_equal(c[0], g[0]) and c[2] == g[2]):
            raise AssertionError(f"GymTrackEnv {env_id} step {i}: cuda != "
                                 f"cpu")
        if c[1] is not None:
            np.testing.assert_allclose(g[1], c[1], rtol=1e-6, atol=1e-6)
        _assert_state_close(torch, c[3], g[3], f"GymTrackEnv {env_id} {i}")


def check_host_update(torch, tconfig, dueling, optim, host_loop, name, mode,
                      gen_cpu, aux="none", single=False):
    """One make_host_update of `name` on the card and the CPU from the same
    parameters, batch and bootstrap noise: loss and grad norm to 1e-4
    relative. Returns them (cuda, cpu)."""
    from active_tracking_rl_torch.ops import noise
    t, b, a, p = 8, 16, 2, 1 if single else 2
    ncfg = tconfig.NetConfig.from_name(name, aux=aux)
    tcfg = tconfig.TrainConfig(num_envs=b, num_steps=t, train_mode=mode)
    params = dueling.build_model(ncfg, a, (13, 13), device="cpu",
                                 generator=gen_cpu, single=single).state_dict()
    g = gen_cpu
    batch = host_loop.HostBatch(
        obs=noise.randint(5, (t + 1, b, p, 1, 13, 13, 1), g).float(),
        actions=1.5 * noise.normal((t, b, p, a), g),
        rewards=noise.normal((t, b, 2), g),
        done=noise.uniform((t, b), g) < 0.1,
        hx0=0.3 * noise.normal((b, p, 128), g),
        cx0=0.3 * noise.normal((b, p, 128), g))
    boot = noise.normal((b, a), g)
    res = {}
    for dev in ("cpu", "cuda"):
        model = dueling.build_model(ncfg, a, (13, 13), device=dev,
                                    single=single)
        model.load_state_dict(params)
        opt = optim.make_optimizer_for(model, tcfg)
        update = host_loop.make_host_update(model, ncfg, tcfg, opt,
                                            not single)
        m = update(host_loop.HostBatch(*(x.to(dev) for x in batch)), mode,
                   boot.to(dev))
        res[dev] = (m.loss.item(), m.grad_norm.item(), m.pred_loss.item())
    for i, what in enumerate(("loss", "grad_norm", "pred_loss")):
        c, gd = res["cpu"][i], res["cuda"][i]
        if not (np.isfinite(gd) and abs(c - gd) <= 1e-4 * max(1.0, abs(c))):
            raise AssertionError(f"host update {name} {what}: cuda {gd} != "
                                 f"cpu {c}")
    return res["cuda"], res["cpu"]


def phase_reference_host(torch, tconfig, env_mod, bridge, dueling, optim,
                         host_loop, gen_cpu):
    """The host trainer's parts on the card against the CPU."""
    t0 = time.perf_counter()
    for env_id in (BENCH_ENV, "Track2D-BlockPartialPZR-v0"):
        check_gym_env(torch, bridge, env_mod, tconfig, env_id, gen_cpu)
    single = check_host_update(torch, tconfig, dueling, optim, host_loop,
                               "maze-lstm-continuous", -1, gen_cpu,
                               single=True)
    tat = check_host_update(torch, tconfig, dueling, optim, host_loop,
                            "tat-maze-lstm-continuous", -1, gen_cpu,
                            aux="reward")
    say("reference-host", t0, f"GymTrackEnv on {BENCH_ENV} and "
        f"Track2D-BlockPartialPZR-v0: reset + 20 steps cuda == cpu (floats "
        f"to 1e-6); make_host_update (cuda vs cpu: loss, grad_norm, "
        f"pred_loss): maze-lstm-continuous single {single[0]} vs "
        f"{single[1]}; tat-maze-lstm-continuous aux, mode -1, {tat[0]} vs "
        f"{tat[1]}")


def phase_host_train(torch, flood, train_host, tmp):
    """run/train_host.py on Nav through the gym bridge; returns launches."""
    t0 = time.perf_counter()
    reset_counts(flood)
    run = train_host.main(HOST_TRAIN_FLAGS + ["--device", "cuda",
                                              "--log-dir", str(tmp)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flood.launches()
    resets = run.trainer.pool.resets
    loss = float(run.last_metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"host-train loss {loss}")
    files = sorted(p.name for p in pathlib.Path(run.run_dir).iterdir())
    for prefix in ("all-", "tracker-", "target-"):
        if not any(f.startswith(prefix) and f.endswith(".msgpack")
                   for f in files):
            raise AssertionError(f"host-train wrote no {prefix}*: {files}")
    if launches["flood_sweep"] != resets or sum(launches.values()) != resets:
        raise AssertionError(f"host-train: {resets} resets, launches "
                             f"{launches} (want flood_sweep once per reset)")
    for line in _log_lines(run.run_dir, "iter ", "checkpoint "):
        say("host-train", t0, line)
    steps = HOST_TRAIN_ITERS * 16 * 20
    say("host-train", t0, f"run/train_host.py: {HOST_TRAIN_ITERS} "
        f"iterations of maze-lstm "
        f"on {BENCH_ENV} at 16 envs x 20 steps in {dt:.3f} s "
        f"({steps / dt:.1f} env-steps/s, setup included); {resets} env "
        f"resets; "
        f"{len(run.trainer.finished_lens)} episodes; loss at iteration "
        f"{HOST_TRAIN_ITERS} {loss:.6f}; files {files}; launches {launches}")

    # where its time goes: one env's reset, and its step, alone
    env = run.trainer.pool.envs[0]
    t1 = time.perf_counter()
    for _ in range(5):
        env.reset()
    torch.cuda.synchronize()
    reset_s = (time.perf_counter() - t1) / 5
    t1 = time.perf_counter()
    for _ in range(20):
        env.step([0, 0])
    step_ms = (time.perf_counter() - t1) / 20 * 1e3
    say("host-train-parts", t0, f"one GymTrackEnv reset {reset_s:.4f} s "
        f"(mean of 5), one step {step_ms:.3f} ms (mean of 20): "
        f"{resets} resets ~{resets * reset_s:.1f} s of the run")
    return launches


def phase_host_single(torch, flood, tconfig, dueling, bridge, host_loop):
    """A single-player discrete HostTrainer on the toy single-agent env:
    every episode of length 10 is recorded."""
    t0 = time.perf_counter()
    reset_counts(flood)
    pool = bridge.HostEnvPool([(lambda i=i: ToyImageEnv(i))
                               for i in range(3)])
    ncfg = tconfig.NetConfig.from_name("maze-lstm", aux="none")
    tcfg = tconfig.TrainConfig(num_envs=3, num_steps=6, train_mode=0)
    model = dueling.build_model(ncfg, 4, (13, 13), device="cuda",
                                single=True)
    tr = host_loop.HostTrainer(model, ncfg, tcfg, pool, seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(3):
        m = tr.train_iter(mode=0)
    torch.cuda.synchronize()
    moved = sum(float((model.state_dict()[k] - v).abs().sum())
                for k, v in before.items())
    if not (np.isfinite(m.loss.item()) and moved > 0
            and len(tr.finished_lens) >= 3
            and set(tr.finished_lens) == {10}):
        raise AssertionError(f"host-single: loss {m.loss.item()}, moved "
                             f"{moved}, episodes {tr.finished_lens}")
    say("host-single", t0, f"maze-lstm single on 3 toy envs, 3 x 6 steps: "
        f"episodes {[int(x) for x in tr.finished_lens]}, loss "
        f"{m.loss.item():.6f}")
    return flood.launches()


def _learn_direction(tconfig, dueling, host_loop, tat, seed, device="cuda",
                     mode=None):
    """One continuous learning run on the direction pool (train mode -1 for
    the TAT bar, 0 for the tracker's unless `mode` says otherwise); returns
    the finished episodes' returns and each iteration's pred_loss."""
    name = "tat-maze-lstm-continuous" if tat else "maze-lstm-continuous"
    mode = (-1 if tat else 0) if mode is None else mode
    tcfg = tconfig.TrainConfig(num_envs=32, num_steps=8, train_mode=mode,
                               lr=1e-3,
                               entropy_target=0.01 if tat else 0.2)
    ncfg = tconfig.NetConfig.from_name(name, aux="reward" if tat else "none")
    model = dueling.build_model(ncfg, 2, (13, 13), device=device,
                                single=not tat)
    tr = host_loop.HostTrainer(model, ncfg, tcfg,
                               DirectionPool(32, seed=5,
                                             players=2 if tat else 1),
                               seed=seed, action_low=np.full(2, -2.0),
                               action_high=np.full(2, 2.0))
    iters = LEARN_TAT_CONT_ITERS if tat else LEARN_CONT_ITERS
    preds = [tr.train_iter(mode=mode).pred_loss for _ in range(iters)]
    return (np.asarray(tr.finished_returns, np.float64),
            np.array([float(x) for x in preds]))


def _thirds(rets):
    """Mean return of the first and of the last third of the episodes."""
    return rets[:len(rets) // 3].mean(), rets[-len(rets) // 3:].mean()


def _by10(preds):
    """Means of each 10 iterations, to 3 places."""
    return [round(float(preds[i:i + 10].mean()), 3)
            for i in range(0, len(preds), 10)]


def _tat_bar(rets, preds):
    """(early return, late return, pred_loss of the last 20 iterations over
    that of the first 20, whether tests/test_continuous_tat.py's bar holds:
    late > early + 2 and that ratio < 0.8)."""
    early, late = _thirds(rets)
    ratio = preds[-20:].mean() / preds[:20].mean()
    return early, late, ratio, (len(rets) > 30 and late > early + 2.0
                                and ratio < 0.8)


def phase_learn_continuous(flood, tconfig, dueling, host_loop):
    """tests/test_continuous.py's bar: maze-lstm-continuous, 120
    iterations, late return > early + 2 and > 4."""
    t0 = time.perf_counter()
    reset_counts(flood)
    rets, _ = _learn_direction(tconfig, dueling, host_loop, False, 0)
    early, late = _thirds(rets)
    msg = (f"maze-lstm-continuous single, {LEARN_CONT_ITERS} iterations at "
           f"32 envs x 8 steps: {len(rets)} episodes, return early "
           f"{early:.3f} -> late {late:.3f} (bar: +2 and > 4)")
    if not (len(rets) > 30 and late > early + 2.0 and late > 4.0):
        raise AssertionError(f"learn-continuous: {msg}")
    say("learn-continuous", t0, msg)
    return flood.launches()


def _learn_tat_run(job):
    """One run of the TAT bar, job = (device, seed, train mode), in a
    process of its own: float32 without TF32 and deterministic algorithms,
    as in main(), one thread on the CPU. Returns its returns, pred_losses and flood launches."""
    device, seed, mode = job
    import torch
    _no_tf32()
    _deterministic()
    if device == "cpu":
        torch.set_num_threads(1)
    from active_tracking_rl_torch import config as tconfig
    from active_tracking_rl_torch.models import dueling
    from active_tracking_rl_torch.ops import flood
    from active_tracking_rl_torch.rl import host_loop
    reset_counts(flood)
    rets, preds = _learn_direction(tconfig, dueling, host_loop, True, seed,
                                   device, mode)
    return rets, preds, flood.launches()


def start_tat_cpu_run():
    """Starts the TAT bar's seeds on the CPU in spawned processes, which
    overlap the card's phases; returns (process pool, pending results)."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(len(LEARN_TAT_SEEDS))
    return pool, pool.map_async(_learn_tat_run,
                                [("cpu", s, -1) for s in LEARN_TAT_SEEDS])


def _tat_agreement(card_preds, cpu_preds) -> float:
    """The largest relative gap of the card's pred_loss from the CPU's over
    the first LEARN_TAT_AGREE iterations."""
    n = LEARN_TAT_AGREE
    return float(np.max(np.abs(card_preds[:n] - cpu_preds[:n])
                        / np.abs(cpu_preds[:n])))


def phase_learn_tat_continuous(torch, flood, tconfig, dueling, host_loop,
                               cpu_run):
    """tests/test_continuous_tat.py's bar as written, on the card:
    tat-maze-lstm-continuous with the aux reward at mode -1, 150
    iterations, late return > early + 2 and the mean pred_loss of the last
    20 iterations < 0.8 x that of the first 20, met by a majority of
    LEARN_TAT_SEEDS on the card and on the CPU (HostTrainer draws on the
    host: the same parameters and noise); each seed's card pred_loss within
    LEARN_TAT_AGREE_TOL of the CPU's over its first LEARN_TAT_AGREE
    iterations."""
    t0 = time.perf_counter()
    reset_counts(flood)
    card = [_learn_direction(tconfig, dueling, host_loop, True, seed)
            for seed in LEARN_TAT_SEEDS]
    torch.cuda.synchronize()
    launches = flood.launches()
    dt = time.perf_counter() - t0
    pool, pending = cpu_run
    cpu = pending.get(timeout=900)
    pool.close()
    pool.join()
    for _, _, c_launches in cpu:
        if sum(c_launches.values()):
            raise AssertionError(f"learn-tat-continuous on the CPU launched "
                                 f"{c_launches}")
    parts, met, agree = [], {"cuda": 0, "cpu": 0}, []
    for seed, (g_rets, g_preds), (c_rets, c_preds, _) in zip(
            LEARN_TAT_SEEDS, card, cpu):
        text = []
        for dev, rets, preds in (("cuda", g_rets, g_preds),
                                 ("cpu", c_rets, c_preds)):
            early, late, ratio, passed = _tat_bar(rets, preds)
            met[dev] += passed
            text.append(f"{dev} return {early:.3f} -> {late:.3f}, pred_loss "
                        f"x{ratio:.3f} ({'meets' if passed else 'misses'}), "
                        f"by 10 iterations {_by10(preds)}")
        agree.append(_tat_agreement(g_preds, c_preds))
        parts.append(f"seed {seed}: " + "; ".join(text) + f"; first "
                     f"{LEARN_TAT_AGREE} iterations within {agree[-1]:.3g}")
    need = len(LEARN_TAT_SEEDS) // 2 + 1
    msg = (f"tat-maze-lstm-continuous, aux reward, mode -1, seeds "
           f"{list(LEARN_TAT_SEEDS)}, {LEARN_TAT_CONT_ITERS} iterations at 32 "
           f"envs x 8 steps, {dt:.3f} s on the card (bar: +2 and x0.8 on "
           f"{need} of {len(LEARN_TAT_SEEDS)} seeds; card vs cpu over the "
           f"first {LEARN_TAT_AGREE} iterations within "
           f"{LEARN_TAT_AGREE_TOL:g}): met on the card {met['cuda']}, on the "
           f"cpu {met['cpu']}; largest early gap {max(agree):.3g}; "
           + " | ".join(parts) + f"; launches {launches}")
    if not (min(met.values()) >= need
            and max(agree) <= LEARN_TAT_AGREE_TOL):
        raise AssertionError(f"learn-tat-continuous: {msg}")
    say("learn-tat-continuous", t0, msg)
    return launches


def tat_sweep(seeds, devices, control) -> int:
    """The TAT bar for each of `seeds` on each of `devices` (and, with
    `control`, at train mode 0, where the target and its aux head do not
    learn), each run in a spawned process, 8 at a time; prints each run and
    each (device, mode)'s summary. Returns 0."""
    import multiprocessing
    modes = (-1, 0) if control else (-1,)
    jobs = [(d, s, m) for m in modes for d in devices for s in seeds]
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(min(8, len(jobs))) as pool:
        runs = dict(zip(jobs, pool.map(_learn_tat_run, jobs)))
    ratios = {}
    for (dev, seed, mode), (rets, preds, launches) in runs.items():
        early, late, ratio, passed = _tat_bar(rets, preds)
        ratios[dev, seed, mode] = ratio
        say("tat-seeds", t0, f"{dev} mode {mode} seed {seed}: return "
            f"{early:.3f} -> {late:.3f}, pred_loss x{ratio:.3f} "
            f"({'meets' if passed else 'misses'} the bar), by 10 iterations "
            f"{_by10(preds)}; "
            f"launches {launches}")
    for mode in modes:
        for dev in devices:
            r = np.array([ratios[dev, s, mode] for s in seeds])
            mean = np.mean([runs[dev, s, mode][1] for s in seeds], axis=0)
            say("tat-seeds", t0, f"{dev} mode {mode}, seeds {list(seeds)}: "
                f"ratios mean {r.mean():.3f}, min {r.min():.3f}, max "
                f"{r.max():.3f}, {int((r >= 0.8).sum())} at or above 0.8; "
                f"seed-mean curve x{mean[-20:].mean() / mean[:20].mean():.3f}")
        if {"cuda", "cpu"} <= set(devices):
            gaps = [float(np.max(np.abs(runs["cuda", s, mode][1]
                                        - runs["cpu", s, mode][1])
                                 / np.abs(runs["cpu", s, mode][1])))
                    for s in seeds]
            diffs = [round(float(ratios["cuda", s, mode]
                                 - ratios["cpu", s, mode]), 4) for s in seeds]
            early = [_tat_agreement(runs["cuda", s, mode][1],
                                    runs["cpu", s, mode][1]) for s in seeds]
            say("tat-seeds", t0, f"mode {mode}, cuda vs cpu per seed: "
                f"ratio gaps {diffs}, largest relative pred_loss gaps "
                f"{[float(f'{g:.3g}') for g in gaps]}, over the first "
                f"{LEARN_TAT_AGREE} iterations "
                f"{[float(f'{g:.3g}') for g in early]}")
    return 0


def phase_random_agent(torch, flood, random_agent):
    """run/random_agent.py on Nav: FPS mode at 4096 envs, then one episode;
    returns each mode's launches."""
    t0 = time.perf_counter()
    reset_counts(flood)
    out = random_agent.main(["-e", BENCH_ENV, "--num-envs",
                             str(RANDOM_AGENT_ENVS), "--seconds",
                             str(RANDOM_AGENT_SECONDS), "--device", "cuda"])
    fps_launches = flood.launches()
    if fps_launches["flood_sweep"] < 1 or sum(fps_launches.values()) != \
            fps_launches["flood_sweep"]:
        raise AssertionError(f"random-agent launched {fps_launches}")
    say("random-agent", t0, f"{RANDOM_AGENT_ENVS} envs on {BENCH_ENV}, "
        f"{out['blocks']} blocks of 20 random steps in {out['seconds']:.3f} "
        f"s: {out['fps']:.1f} env-steps/s (the reset not timed); launches "
        f"{fps_launches}")
    t1 = time.perf_counter()
    reset_counts(flood)
    eps = random_agent.main(["-e", BENCH_ENV, "--episodes", "1",
                             "--device", "cuda"])
    ep_launches = flood.launches()
    if ep_launches["flood_sweep"] != 1 or sum(ep_launches.values()) != 1:
        raise AssertionError(f"random-agent --episodes 1 launched "
                             f"{ep_launches}")
    say("random-agent-episodes", t1, f"1 episode of length {eps[0][0]}, "
        f"rewards {eps[0][1].round(3).tolist()}; launches {ep_launches}")
    return fps_launches, ep_launches


def _no_tf32():
    """float32 means float32: no TF32 in matmuls or cuDNN convolutions, as
    every entry point of the port pins it (utils/platform.py:pin_float32).
    Returns the state as read back."""
    from active_tracking_rl_torch.utils.platform import pin_float32
    return pin_float32()


def _deterministic():
    """Deterministic algorithms only, as every entry point of the port pins
    them (utils/platform.py:pin_deterministic). Returns the settings as
    read back."""
    from active_tracking_rl_torch.utils.platform import pin_deterministic
    return pin_deterministic()


def _mp_check_rank(port):
    """dp-nccl's rank, in a process of its own: parallel/mp_check.py as a
    group of one over nccl on cuda:0. Returns its line's fields and its
    flood launches (mp_check.main pins float32 itself)."""
    from active_tracking_rl_torch.ops import flood
    from active_tracking_rl_torch.parallel import mp_check
    out = mp_check.main(["--coordinator", f"127.0.0.1:{port}",
                         "--num-processes", "1", "--process-id", "0",
                         "--device", "cuda", "--dist-backend", "nccl",
                         "--timeout", str(DP_TIMEOUT)])
    return out, flood.launches()


def start_dp_nccl():
    """Starts dp-nccl's rank in a spawned process, which overlaps the
    scaling phase (both spend their time starting a process; the rank's 3
    steps are tiny); returns (t0, process pool, pending result)."""
    import multiprocessing
    from active_tracking_rl_torch.parallel.mesh import free_port
    pool = multiprocessing.get_context("spawn").Pool(1)
    return (time.perf_counter(), pool,
            pool.apply_async(_mp_check_rank, (free_port(),)))


def phase_dp_nccl(torch, flood, started):
    """parallel/mp_check.py as one spawned rank over nccl on cuda:0: its
    digest equals, bit for bit, that of the same three steps in this
    process without a process group."""
    from active_tracking_rl_torch.parallel import mp_check
    t0, pool, pending = started
    try:
        out, launches = pending.get(timeout=DP_TIMEOUT)
    finally:
        pool.terminate()
    model, _, m = mp_check.run_check(1, "cuda", 3)
    torch.cuda.synchronize()
    want = mp_check.digest(model)
    if (out["world"], out["digest"]) != (1, want) or \
            out["loss"] != float(m.loss) or sum(launches.values()):
        raise AssertionError(f"dp-nccl: rank {out} (launches {launches}) vs "
                             f"one process: digest {want}, loss "
                             f"{float(m.loss)}")
    say("dp-nccl", t0, f"(started with scaling) mp_check over nccl, "
        f"world 1 on cuda:0: MPCHECK "
        f"rank={out['rank']} loss={out['loss']:.6f} digest={out['digest']} "
        f"world={out['world']}; equal to 3 steps without a process group "
        f"bit for bit; launches {launches}")
    return launches


class _RowLog:
    """Wraps a flood launcher: keeps each launch's row count, then calls
    the launcher (whose count is the launch count)."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.rows = []

    def __call__(self, maze, goals, iters):
        self.rows.append(int(maze.shape[0]))
        return self.kernel(maze, goals, iters)


def _dp_train_rank(rank, port, argv):
    """One rank of dp-train in a process of its own: run/train.py:main as
    rank `rank` of 2 over gloo on cuda:0. Returns its run dir, files, eval
    lines, parameters (on the host), flood launches and their row counts,
    and its seconds (run/train.py pins float32 itself)."""
    import torch
    from active_tracking_rl_torch.ops import flood
    from active_tracking_rl_torch.parallel import mp_check
    from active_tracking_rl_torch.run import train as train_cli
    reset_counts(flood)
    log = flood.KERNELS["sweep"] = _RowLog(flood.KERNELS["sweep"])
    t0 = time.perf_counter()
    s = train_cli.main(argv + ["--coordinator", f"127.0.0.1:{port}",
                               "--num-processes", "2", "--process-id",
                               str(rank)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"run_dir": s.run_dir,
            "files": sorted(p.name for p in pathlib.Path(s.run_dir).iterdir()),
            "evals": [re.sub(r" \([0-9.]+ s\)", "", line)
                      for line in _log_lines(s.run_dir, "eval ")],
            "digest": mp_check.digest(s.model),
            "params": {k: v.cpu() for k, v in s.model.state_dict().items()},
            "launches": {k.name: k.launches for k in (
                flood.FLOOD_SWEEP, flood.FLOOD_SWEEP16, flood.FLOOD_RELAX)},
            "rows": log.rows, "seconds": dt}


def phase_dp_train(torch, flood, train_cli, learner, curriculum, tmp):
    """The trainer CLI as 2 ranks over gloo on cuda:0 (the main config),
    then the same seed in one process with pool_blocks=2."""
    import multiprocessing
    from active_tracking_rl_torch.parallel.mesh import free_port
    t0 = time.perf_counter()
    argv = DP_TRAIN_FLAGS + ["--log-dir", str(tmp)]
    port = free_port()
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        pending = [pool.apply_async(_dp_train_rank, (r, port, argv))
                   for r in range(2)]
        ranks = [p.get(timeout=DP_TIMEOUT) for p in pending]
    t_ranks = time.perf_counter() - t0
    lead, other = ranks
    if lead["digest"] != other["digest"] or lead["evals"] != other["evals"] \
            or not lead["evals"]:
        raise AssertionError(f"dp-train: the ranks differ: digests "
                             f"{lead['digest']} {other['digest']}, evals "
                             f"{lead['evals']} {other['evals']}")
    if other["run_dir"] != lead["run_dir"] + "-r1" or any(
            f.endswith(".msgpack") or f in ("train_state.pt",
                                            "ckpt_meta.json")
            for f in other["files"]) or "train_state.pt" not in lead["files"]:
        raise AssertionError(f"dp-train: lead wrote {lead['files']}, rank 1 "
                             f"{other['files']}")
    # each rank: its initial carry, its pool block each iteration, the eval
    want_rows = ([DP_ENVS // 2] + [DP_POOL // 2] * DP_ITERS
                 + [DP_TEST_EPS])
    for r in ranks:
        if r["rows"] != want_rows or r["launches"]["flood_sweep"] != len(
                want_rows) or sum(r["launches"].values()) != len(want_rows):
            raise AssertionError(f"dp-train: a rank launched {r['launches']} "
                                 f"at rows {r['rows']} (want flood_sweep at "
                                 f"{want_rows})")
    # the same seed in one process: what the two ranks compute
    t1 = time.perf_counter()
    reset_counts(flood)
    s = train_cli.setup(argv + ["--run-name", "one-process"])
    try:
        step = learner.make_train_step(s.model, s.env, s.ncfg, s.tcfg, s.opt,
                                       pool_blocks=2)
        carry = s.carry
        for it in range(1, DP_ITERS + 1):
            s.cur = curriculum.update(s.tcfg, s.cur, it)
            carry, _, _ = step(carry, s.cur.mode)
        torch.cuda.synchronize()
    finally:
        train_cli.close_logger(s.log)
    one_launches = flood.launches()
    worst = 0.0
    for k, want in s.model.state_dict().items():
        got = lead["params"][k].to(want.device)
        worst = max(worst, float((got - want).abs().max()
                                 / want.abs().max().clamp_min(1e-30)))
    if not worst <= DP_PARAM_RTOL:
        raise AssertionError(f"dp-train: 2 ranks vs one process with "
                             f"pool_blocks=2: parameters differ by {worst:.3g}"
                             f" of their scale (bound {DP_PARAM_RTOL})")
    sps = DP_ITERS * DP_ENVS * NUM_STEPS / lead["seconds"]
    say("dp-train", t0, f"run/train.py as 2 gloo ranks on cuda:0, "
        f"maze-lstm on {BENCH_ENV} at {DP_ENVS} envs, pool {DP_POOL}, "
        f"{DP_ITERS} iterations and one eval of {DP_TEST_EPS} episodes in "
        f"{t_ranks:.3f} s ({lead['seconds']:.3f} s in rank 0's main: "
        f"{sps:.1f} env-steps/s, setup and eval included; two ranks share "
        f"one card); digests {lead['digest']} = {other['digest']}; evals "
        f"{lead['evals']} on both; rank 1 wrote {other['files']}; each "
        f"rank's flood_sweep rows {lead['rows']}, launches "
        f"{lead['launches']}; one process with pool_blocks=2 "
        f"({time.perf_counter() - t1:.3f} s, launches {one_launches}): "
        f"parameters within {worst:.3g} of their scale (bound "
        f"{DP_PARAM_RTOL})")
    return {k: lead["launches"][k] + other["launches"][k]
            for k in lead["launches"]}


def phase_scaling(scaling):
    """parallel/scaling.py --dp 1 2: a row at dp 1, a skipped row at dp 2
    (one card)."""
    t0 = time.perf_counter()
    out = scaling.main(["--dp", "1", "2", "--envs-per-device",
                        str(SCALING_ENVS), "--iters", str(SCALING_ITERS),
                        "--device", "cuda", "--timeout", str(DP_TIMEOUT)])
    one, two = out["rows"]
    if not (one["dp"] == 1 and one["weak_scaling_eff"] == 1.0
            and np.isfinite(one["env_steps_per_s"])
            and two == {"dp": 2, "skipped": "> 1 visible CUDA device(s)"}):
        raise AssertionError(f"scaling: {out}")
    launches = one["flood_launches"]
    if launches["flood_sweep"] != 3 + SCALING_ITERS or \
            sum(launches.values()) != launches["flood_sweep"]:
        raise AssertionError(f"scaling: rank 0 launched {launches}")
    say("scaling", t0, f"--dp 1 2 at {SCALING_ENVS} envs per device: dp 1 "
        f"{one['env_steps_per_s']:.1f} env-steps/s (a step "
        f"{one['step_s']:.4f} s, mean of {SCALING_ITERS}), dp 2 {two}; "
        f"rank 0 launched {launches}")
    return launches


def phase_profile(torch, flood, profile_summary, tmp):
    """run/profile_summary.py --capture on the card: a device trace whose
    shares sum to 1."""
    t0 = time.perf_counter()
    reset_counts(flood)
    s = profile_summary.main(["--capture", "--trace-dir", str(tmp),
                              "--top", "5"])
    launches = flood.launches()
    shares = s["categories"]
    if s["mode"] != "device" or abs(sum(shares.values()) - 1) > 1e-3 \
            or not s["top_ops"]:
        raise AssertionError(f"profile: {s}")
    # the pool and the initial carry flood; the captured steps reuse the pool
    if launches["flood_sweep"] != 2 or sum(launches.values()) != 2:
        raise AssertionError(f"profile launched {launches}")
    tops = "; ".join(f"{o['name'][:70]} {o['ms']:.3f} ms x{o['count']} "
                     f"({o['share']:.1%})" for o in s["top_ops"])
    say("profile", t0, f"torch.profiler, 3 train steps of maze-lstm on "
        f"{BENCH_ENV} at 4096 envs on a given pool (remat on): window "
        f"{s['window_ms']:.3f} ms, device time {s['total_device_ms']:.3f} "
        f"ms, busy {s['busy_ms']:.3f} ms; shares kernel "
        f"{shares['kernel']:.4f}, memcpy {shares['memcpy']:.4f}, memset "
        f"{shares['memset']:.4f}, idle {shares['idle']:.4f}; top 5: {tops}; "
        f"launches {launches}")
    return launches


def phase_demo(torch, flood, demo, run_dir, tmp):
    """run/demo.py with cli-train's tracker and target, one Nav episode."""
    t0 = time.perf_counter()
    files = ["--device", "cuda", "--env", BENCH_ENV, "--load-tracker",
             str(pathlib.Path(run_dir) / "tracker-best.msgpack"),
             "--load-target", str(pathlib.Path(run_dir) / "target-best.msgpack")]
    gif = pathlib.Path(tmp) / "demo.gif"
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
        try:
            demo.main(files + ["--gif", str(gif)])
        except ImportError as e:
            case = f"no PIL here: --gif raised ({e}); ran with --gif ''"
        else:
            raise AssertionError("demo: --gif without PIL did not raise")
    reset_counts(flood)
    (frames, length, ret), = demo.main(
        files + ["--gif", str(gif) if have_pil else ""])
    torch.cuda.synchronize()
    launches = flood.launches()
    if have_pil:
        if not gif.is_file():
            raise AssertionError("demo wrote no GIF")
        case = f"PIL here: wrote {gif.stat().st_size} bytes of GIF"
    if len(frames) != length + 1 or launches["flood_sweep"] != 1 or \
            sum(launches.values()) != 1:
        raise AssertionError(f"demo: {len(frames)} frames for length "
                             f"{length}, launches {launches}")
    say("demo", t0, f"one greedy episode on {BENCH_ENV}: length {length}, "
        f"tracker return {ret:.3f}, {len(frames)} frames; {case}; launches "
        f"{launches}")
    return launches


def phase_parity(flood, parity, tmp):
    """run/parity.py record, then verify on the card (exit 0); verify of a
    copy with one observation changed exits 1."""
    t0 = time.perf_counter()
    golden = pathlib.Path(tmp) / "golden.npz"
    reset_counts(flood)
    parity.main(["record", "--env", BENCH_ENV, "--device", "cuda", "--out",
                 str(golden)])
    codes = []
    try:
        parity.main(["verify", "--golden", str(golden), "--device", "cuda"])
    except SystemExit as e:
        codes.append(e.code)
    launches = flood.launches()
    g = dict(np.load(golden))
    g["obs"] = g["obs"].copy()
    g["obs"][5, 0, 0, 0] ^= 1
    bad = pathlib.Path(tmp) / "tampered.npz"
    np.savez_compressed(bad, **g)
    try:
        parity.main(["verify", "--golden", str(bad), "--device", "cuda"])
    except SystemExit as e:
        codes.append(e.code)
    if codes != [0, 1] or launches["flood_sweep"] != 4 or \
            sum(launches.values()) != 4:
        raise AssertionError(f"parity: exit codes {codes} (want [0, 1]), "
                             f"launches {launches}")
    say("parity", t0, f"record and verify of {len(g['actions'])} steps "
        f"(2 episodes) on {BENCH_ENV} on the card: verify exit 0; a copy "
        f"with one observation changed: exit 1; launches {launches}")
    return launches


def parse_args(argv):
    import argparse
    p = argparse.ArgumentParser(description="The port's smoke on one GPU; "
                                "with --tat-seeds, the TAT bar's seed sweep "
                                "alone.")
    p.add_argument("--tat-seeds", default=None,
                   help="seeds of the sweep, as 0-7 or 0,3,5")
    p.add_argument("--tat-devices", default="cuda,cpu",
                   help="devices of the sweep (default cuda,cpu)")
    p.add_argument("--tat-control", action="store_true",
                   help="also run each seed at train mode 0")
    p.add_argument("--update-check", nargs="?", const="", default=None,
                   metavar="TRACKER",
                   help="run only the K=16 Nav update check, card against "
                   "CPU, at the recipe's batch: fresh, sharpened, and from "
                   "the flax-format tracker file TRACKER if given")
    return p.parse_args(argv)


#: the K=16 Nav recipe's batch: 1024 envs, a pool of 256
RECIPE_ENVS, RECIPE_POOL = 1024, 256


def update_sweep(tracker, envs=RECIPE_ENVS, pool=RECIPE_POOL) -> int:
    """The update check alone: fresh, low-entropy, and from `tracker`."""
    import torch
    _no_tf32()
    _deterministic()
    cases = [("fresh", None, False), ("low-entropy", None, True)]
    if tracker:
        cases.append((f"tracker {tracker}", tracker, False))
    failed = 0
    for what, path, low in cases:
        t0 = time.perf_counter()
        try:
            res = check_update(torch, envs, pool,
                               draw_gen(0),
                               tracker=path, low_entropy=low)
            text = update_text(res)
        except AssertionError as e:
            failed += 1
            text = f"FAILED: {e}"
        say("update", t0, f"{what} at {envs} envs, pool {pool}: {text}")
    return 1 if failed else 0


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse_args(argv)
    import torch
    devices = args.tat_devices.split(",")
    if not torch.cuda.is_available() and (args.tat_seeds is None
                                          or "cuda" in devices):
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if args.tat_seeds is not None:
        lo, _, hi = args.tat_seeds.partition("-")
        seeds = (range(int(lo), int(hi) + 1) if hi else
                 [int(x) for x in args.tat_seeds.split(",")])
        return tat_sweep(list(seeds), devices, args.tat_control)
    if args.update_check is not None:
        return update_sweep(args.update_check or None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    precision = _no_tf32()
    determinism = _deterministic()
    say("device", t_start, f"{torch.cuda.get_device_name(0)} | {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | float32 "
        f"{precision} | deterministic {determinism}")

    from active_tracking_rl_torch import config as tconfig
    from active_tracking_rl_torch.envs import bridge
    from active_tracking_rl_torch.envs import env as env_mod
    from active_tracking_rl_torch.envs import maps
    from active_tracking_rl_torch.models import dueling
    from active_tracking_rl_torch.ops import flood
    from active_tracking_rl_torch.parallel import scaling
    from active_tracking_rl_torch.rl import (checkpoint, curriculum,
                                             evaluate, host_loop, learner,
                                             optim)
    from active_tracking_rl_torch.run import eval as eval_cli
    from active_tracking_rl_torch.run import (bench, bench_flood, demo,
                                              eval_matrix, parity,
                                              profile_iter, profile_summary,
                                              random_agent)
    from active_tracking_rl_torch.run import train as train_cli
    from active_tracking_rl_torch.run import train_host

    cpu_run = nccl_run = None
    try:
        phase_build(flood)

        gen = draw_gen(0, "cuda")
        rows, (pool_mz, pool_goals) = phase_kernel(torch, flood, maps,
                                                   tconfig, gen)
        phase_reference(torch, tconfig, env_mod, learner, dueling, evaluate,
                        draw_gen(0))
        phase_reference_host(torch, tconfig, env_mod, bridge, dueling, optim,
                             host_loop, draw_gen(1))
        paths = {}
        paths["main"], main_bench = phase_main(
            torch, flood, bench, profile_iter, learner, "main", BENCH_ENV,
            None, "flood_sweep", ("flood_relax", "flood_sweep16"))
        phase_repro(torch, train_cli, main_bench)
        del main_bench
        paths["maze-main"], _ = phase_main(
            torch, flood, bench, profile_iter, learner, "maze-main",
            MAZE_ENV, "pallas", "flood_relax",
            ("flood_sweep", "flood_sweep16"))
        paths["bench-flood"] = phase_bench_flood(torch, flood, bench_flood)
        model, ncfg, tcfg, paths["advat"] = phase_advat(
            torch, flood, tconfig, env_mod, learner, dueling, curriculum)
        paths["advat-eval"] = phase_advat_eval(
            torch, flood, tconfig, env_mod, evaluate, model, ncfg, tcfg)
        paths["sweep16-entry"] = phase_sweep16_entry(torch, flood, pool_mz,
                                                     pool_goals)
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            first, paths["cli-train"] = phase_cli_train(
                torch, flood, train_cli, tmp / "train")
            paths["cli-resume"] = phase_cli_resume(torch, flood, train_cli,
                                                   checkpoint, first,
                                                   tmp / "train")
            paths["cli-eval"] = phase_cli_eval(
                torch, flood, tconfig, env_mod, dueling, evaluate, checkpoint,
                eval_cli, eval_matrix, first.run_dir, tmp / "eval")
            # the TAT bar's CPU run overlaps the card's phases from here
            cpu_run = start_tat_cpu_run()
            paths["cli-nets"] = phase_cli_nets(torch, flood, train_cli,
                                               learner, optim, tmp / "nets")
            paths["host-train"] = phase_host_train(torch, flood, train_host,
                                                   tmp / "host")
            paths["learn"] = phase_learn(torch, flood, tconfig, env_mod,
                                         learner, dueling, evaluate)
            paths["host-single"] = phase_host_single(
                torch, flood, tconfig, dueling, bridge, host_loop)
            paths["learn-continuous"] = phase_learn_continuous(
                flood, tconfig, dueling, host_loop)
            paths["learn-tat-continuous"] = phase_learn_tat_continuous(
                torch, flood, tconfig, dueling, host_loop, cpu_run)
            paths["random-agent"], paths["random-agent-episodes"] = \
                phase_random_agent(torch, flood, random_agent)
            paths["dp-train"] = phase_dp_train(torch, flood, train_cli,
                                               learner, curriculum,
                                               tmp / "dp")
            nccl_run = start_dp_nccl()
            paths["scaling"] = phase_scaling(scaling)
            paths["dp-nccl"] = phase_dp_nccl(torch, flood, nccl_run)
            paths["profile"] = phase_profile(torch, flood, profile_summary,
                                             tmp / "profile")
            paths["demo"] = phase_demo(torch, flood, demo, first.run_dir,
                                       tmp)
            paths["parity"] = phase_parity(flood, parity, tmp)
        # each kernel's launches on the path that runs it
        for name, path in (("flood_sweep", "main"),
                           ("flood_relax", "maze-main"),
                           ("flood_sweep16", "sweep16-entry")):
            rows[name]["launches"] = paths[path][name]
        for name, row in rows.items():
            row["launches_by_path"] = {p: n[name] for p, n in paths.items()}

        say("total", t_start)
        print(json.dumps({"kernels": [rows[k] for k in SOURCES]}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    finally:
        if cpu_run is not None:
            cpu_run[0].terminate()
        if nccl_run is not None:
            nccl_run[1].terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
