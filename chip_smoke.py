#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of the repository, with no install step:

    python3 chip_smoke.py

Phases (each prints one line with its seconds):
  1. device: needs CUDA, prints `nvidia-smi --query-gpu=name,power.limit`;
  2. build: compiles csrc/flood_sweep.cu with nvcc (plain C interface, ctypes);
  3. kernel: the flood kernel against its plain PyTorch twin on the card, bit
     for bit, at the main path's shape (512 mazes x 16 goals at S=82) on Block
     maps of two densities and Empty maps, on perfect mazes of side 81, at
     iters 48 and 256, with a G that is not a multiple of 16 and (-1,-1) goal
     pads; prints the kernel's and the twin's time;
  4. reference: on a small input, the port on the card agrees with the port on
     the CPU (where the flood is the plain twin): reset bit for bit, one train
     step's loss to a stated tolerance;
  5. main path: Track2D-BlockPartialNav-v0, maze-lstm at full width, train
     mode 0, 4096 envs, a reset pool of 512 refreshed every iteration, 20
     steps: init_learner, one untimed warm-up step, then 3 timed train steps;
     the loss must be finite and the flood kernel must have been launched in
     the timed steps; prints their (warm) env-steps/s, then the time of one
     reset pool and of one train step on a given pool.
Then one JSON line with the kernel table, the card's line from nvidia-smi,
and the last line {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero without the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and 32-bit non-tensor ops/s.
PEAK_BYTES_S = 3.35e12
PEAK_OPS32_S = 67e12

BENCH_ENV = "Track2D-BlockPartialNav-v0"
NUM_ENVS, RESET_POOL, NUM_STEPS, TRAIN_STEPS = 4096, 512, 20, 3


def say(phase: str, t0: float, msg: str = "") -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.3f} s {msg}".rstrip(),
          flush=True)


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
    """Build the kernel, or reuse a library newer than its source."""
    t0 = time.perf_counter()
    kernel = flood.FLOOD_SWEEP
    lib = kernel.build()
    if kernel.build_seconds is None:
        say("build", t0, f"reused {lib} (newer than its source)")
        return
    ptxas = " | ".join(line.strip() for line in kernel.build_log.splitlines()
                       if "registers" in line or "smem" in line)
    say("build", t0, f"nvcc {kernel.build_seconds:.2f} s; {ptxas}")


def phase_kernel(torch, flood, maps, tconfig, gen):
    """Kernel against twin, bit for bit; the kernel's row of the table."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")

    def block_maps(env_id, n, u=None):
        cfg = tconfig.parse_env_id(env_id)
        draws = maps.draw_map(cfg, n, gen, dev)
        if u is not None:
            draws.obstacle_u.fill_(u)
        return maps.generate_block_map(cfg, draws)

    mazes82 = torch.cat([
        block_maps("Track2D-BlockPartialNav-v0", 171, u=1.0),  # 15% walls
        block_maps("Track2D-BlockPartialNav-v1", 171),          # 5% walls
        block_maps("Track2D-EmptyPartialNav-v0", 170)]).contiguous()
    rng = np.random.RandomState(0)
    mazes81 = torch.from_numpy(
        np.stack([perfect_maze(81, rng) for _ in range(16)])).to(dev)

    def goals_for(mz, g):
        s = mz.shape[-1]
        goals = maps.sample_free_cells(
            torch.rand((mz.shape[0], s * s), generator=gen, device=dev),
            mz, g)
        goals[::3, -2:] = -1                  # (-1,-1) pads on every 3rd row
        return goals.contiguous()

    cases = []
    for mz in (mazes82, mazes81):
        goals16 = goals_for(mz, 16)
        for g in (16, 13):
            goals = goals16[:, :g].contiguous()
            for iters in (48, 256):
                got = flood.FLOOD_SWEEP(mz, goals, iters)
                want = flood.flood_fields_plain(mz, goals, iters)
                torch.cuda.synchronize()
                err = int((got.int() - want.int()).abs().max())
                if err != 0:
                    raise AssertionError(
                        f"flood kernel != twin: S={mz.shape[-1]} G={g} "
                        f"iters={iters} max_abs_err={err}")
                cases.append(err)

    # time on main-path data: Block level-0 maps, 16 free goals, iters 256
    cfg = tconfig.parse_env_id(BENCH_ENV)
    mz = block_maps(BENCH_ENV, RESET_POOL)
    goals = maps.sample_free_cells(
        torch.rand((RESET_POOL, cfg.maze_size ** 2), generator=gen,
                   device=dev), mz, cfg.nav_goal_candidates).contiguous()
    iters = cfg.flood_iters
    kernel_ms = cuda_ms(lambda: flood.FLOOD_SWEEP(mz, goals, iters), 20)
    plain_ms = cuda_ms(lambda: flood.flood_fields_plain(mz, goals, iters), 3)
    out = flood.FLOOD_SWEEP(mz, goals, iters)
    n, g, s = mz.shape[0], goals.shape[1], mz.shape[-1]
    bytes_moved = mz.numel() + goals.numel() * 4 + out.numel() * 2
    # an exact BFS relaxes 4 neighbours (add + min) at each reached cell
    ops = 8 * int((out < flood.INF).sum())
    bound_ms = max(bytes_moved / PEAK_BYTES_S, ops / PEAK_OPS32_S) * 1e3
    bound_by = ("bytes" if bytes_moved / PEAK_BYTES_S >= ops / PEAK_OPS32_S
                else "operations")
    say("kernel", t0, f"flood_sweep == twin bit for bit on {len(cases)} cases; "
        f"at {n}x{g}x{s}^2 iters {iters}: kernel {kernel_ms:.4f} ms, "
        f"twin {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(name="flood_sweep", route="cuda",
                source="active_tracking_rl_torch/csrc/flood_sweep.cu",
                replaces="active_tracking_rl_tpu/ops/flood_pallas.py:84",
                launches=None, max_abs_err=max(cases), ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def phase_reference(torch, tconfig, env_mod, learner, dueling, gen_cpu):
    """The port on the card against the port on the CPU, small input."""
    import dataclasses
    t0 = time.perf_counter()
    ecfg = tconfig.parse_env_id(BENCH_ENV)
    ncfg = tconfig.NetConfig.from_name("maze-lstm", aux="none")
    tcfg = tconfig.TrainConfig(env_id=BENCH_ENV, num_envs=16, reset_pool=8,
                               num_steps=8, train_mode=0)
    draws = env_mod.draw_reset(ecfg, 24, gen_cpu, "cpu")

    def to(x, dev):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: to(getattr(x, f.name), dev)
                              for f in dataclasses.fields(x)})
        return x.to(dev) if x is not None else None

    noise = learner.draw_step_noise(8, tcfg.num_envs, 4, gen_cpu, "cpu")
    params = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                 device="cpu", generator=gen_cpu).state_dict()
    results = {}
    for dev in ("cpu", "cuda"):
        env = env_mod.TrackEnv(ecfg, dev)
        state, obs = env.reset(to(draws, dev))
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
        carry, metrics, _ = step(carry, 0, pool, learner.StepNoise(
            *(x.to(dev) for x in noise)))
        results[dev] = dict(state=state.map(lambda x: x.cpu()),
                            carry=carry.env_state.map(lambda x: x.cpu()),
                            loss=metrics.loss.item())
    for name in ("state", "carry"):
        a, b = results["cpu"][name], results["cuda"][name]
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if x.is_floating_point():
                torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-6)
            elif not torch.equal(x, y):
                raise AssertionError(f"cuda != cpu in {name}.{f.name}")
    lc, lg = results["cpu"]["loss"], results["cuda"]["loss"]
    # float32 on both sides with TF32 off: only reduction order differs
    if not abs(lc - lg) <= 1e-4 * max(1.0, abs(lc)):
        raise AssertionError(f"train-step loss cuda {lg} != cpu {lc}")
    say("reference", t0, f"24-row reset bit-exact cuda vs cpu; 8-step train "
        f"loss cuda {lg:.6f} vs cpu {lc:.6f}")


def phase_main(torch, flood, tconfig, env_mod, learner, dueling):
    t0 = time.perf_counter()
    ecfg = tconfig.parse_env_id(BENCH_ENV)
    ncfg = tconfig.NetConfig.from_name("maze-lstm", aux="none")
    tcfg = tconfig.TrainConfig(env_id=BENCH_ENV, num_envs=NUM_ENVS,
                               reset_pool=RESET_POOL, num_steps=NUM_STEPS,
                               train_mode=0)
    env = env_mod.TrackEnv(ecfg, "cuda")
    model = dueling.build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                                device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = learner.init_learner(model, env, ncfg, tcfg, gen)
    step = learner.make_train_step(model, env, ncfg, tcfg, state.opt)
    torch.cuda.synchronize()
    say("main-init", t0, f"init_learner at {NUM_ENVS} envs")

    # one untimed step: the first at these shapes grows the allocator and
    # picks the cuDNN and cuBLAS algorithms
    tw = time.perf_counter()
    carry, _, _ = step(state.carry, tcfg.train_mode)
    torch.cuda.synchronize()
    say("main-warm-up", tw, "one train step, not timed")

    torch.cuda.reset_peak_memory_stats()
    flood.FLOOD_SWEEP.launches = 0
    t1 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        carry, metrics, _ = step(carry, tcfg.train_mode)  # fresh pool each
        losses.append(metrics.loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = flood.FLOOD_SWEEP.launches
    losses = [x.item() for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss {losses}")
    if launches == 0:
        raise AssertionError("the main path never launched flood_sweep")
    sps = TRAIN_STEPS * NUM_ENVS * NUM_STEPS / dt
    say("main", t0, f"{TRAIN_STEPS} train steps in {dt:.3f} s: {sps:.1f} "
        f"env-steps/s; flood_sweep launches {launches} "
        f"({launches / TRAIN_STEPS:g} per iteration); losses {losses}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # where an iteration's time goes: the pool, then a step on that pool
    pool_fn = learner.make_pool_fn(env, tcfg)
    t2 = time.perf_counter()
    pool = pool_fn(gen)
    torch.cuda.synchronize()
    say("main-pool", t2, f"one reset pool of {RESET_POOL} rows "
        "(map, spawns, floods, 512-tick tapes)")
    t3 = time.perf_counter()
    step(carry, tcfg.train_mode, (*pool, learner.init_pool_ptr(device="cuda")))
    torch.cuda.synchronize()
    say("main-step", t3, "one train step on that pool (rollout, loss, "
        "backward, SharedAdam)")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    # float32 means float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", t_start, f"{torch.cuda.get_device_name(0)} | {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    from active_tracking_rl_torch import config as tconfig
    from active_tracking_rl_torch.envs import env as env_mod
    from active_tracking_rl_torch.envs import maps
    from active_tracking_rl_torch.models import dueling
    from active_tracking_rl_torch.ops import flood
    from active_tracking_rl_torch.rl import learner

    phase_build(flood)

    gen = torch.Generator(device="cuda").manual_seed(0)
    row = phase_kernel(torch, flood, maps, tconfig, gen)
    phase_reference(torch, tconfig, env_mod, learner, dueling,
                    torch.Generator().manual_seed(0))
    row["launches"] = phase_main(torch, flood, tconfig, env_mod, learner,
                                 dueling)

    say("total", t_start)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
