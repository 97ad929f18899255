"""Weak scaling of the full train step over data-parallel ranks.

Port of ``active_tracking_rl_tpu/parallel/scaling.py``: the full train step
(pool, rollout, loss, gradient all-reduce, update: ``rl/learner.py``) at a
FIXED number of envs per device. For each `--dp` value W this spawns W
ranks, one process and one device each, joined over ``torch.distributed``
(nccl on cuda, gloo on cpu), at W x `--envs-per-device` envs and a pool of
max(envs // 8, 64); each rank times `--iters` train steps after 2 untimed
ones. Aggregate env-steps/s should grow ~linearly with W while the step
time stays flat; ``weak_scaling_eff`` is each row's env-steps/s per device
over the first row's. Each row also counts rank 0's flood kernel launches
(``flood_launches``: the initial carry, then one pool per step) and lists
every rank's own step seconds (``rank_step_s``). With `--profile-dir` each
rank then runs `--iters` more steps under ``torch.profiler`` (device events
only, on the card), writes ``trace-dp{W}-r{rank}.json`` there, and the row
gains each rank's summary (``rank_profiles``: ``run/profile_summary.py``'s
window, device time, category shares and top ops); the timed steps run
before it, unprofiled.

A W above the visible devices (CUDA cards; on cpu, the cores, one thread
each) gives a ``skipped`` row that names the count, as the JAX harness
marks its oversubscribed rows: ranks are never stacked on a device here,
and such a row is no result.

Usage:
    python -m active_tracking_rl_torch.parallel.scaling --dp 1 2 4 \\
        --envs-per-device 1024
    python -m active_tracking_rl_torch.parallel.scaling --device cpu \\
        --dp 1 2 --envs-per-device 16 --iters 2
    python -m active_tracking_rl_torch.parallel.scaling --dp 1 4 \\
        --profile-dir prof    # where each rank's step goes, at each dp
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from active_tracking_rl_torch.ops import noise

#: the repository root: ranks run ``python -m`` from there
ROOT = Path(__file__).resolve().parents[2]


def visible_devices(device: str) -> int:
    """The devices W ranks may take, one each: the CUDA cards, or on the
    CPU its cores."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def bench_step(args, mesh, device) -> dict:
    """Build and time the data-parallel train step on this rank."""
    from active_tracking_rl_torch.config import (NetConfig, TrainConfig,
                                                 parse_env_id)
    from active_tracking_rl_torch.envs.env import TrackEnv
    from active_tracking_rl_torch.models.dueling import build_model
    from active_tracking_rl_torch.ops import flood
    from active_tracking_rl_torch.rl.learner import (init_learner,
                                                     make_train_step)

    ecfg = parse_env_id(args.env)
    env = TrackEnv(ecfg, device)
    ncfg = NetConfig.from_name(args.network, aux="none")
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, device=device)
    num_envs = args.envs_per_device * mesh.world
    tcfg = TrainConfig(env_id=args.env, num_envs=num_envs,
                       reset_pool=max(num_envs // 8, 64), train_mode=0)
    gen = noise.generator(0, device)
    state = init_learner(model, env, ncfg, tcfg, gen, mesh)
    step = make_train_step(model, env, ncfg, tcfg, state.opt, mesh=mesh)
    carry = state.carry

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mesh.all_reduce_sum(torch.zeros(1, device=device))

    for _ in range(2):
        carry, m, _ = step(carry, 0)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        carry, m, _ = step(carry, 0)
    sync()
    dt = (time.perf_counter() - t0) / args.iters
    if not torch.isfinite(m.loss):
        raise FloatingPointError(f"dp={mesh.world}: non-finite loss")
    row = {"dp": mesh.world, "num_envs": num_envs, "step_s": dt,
           "env_steps_per_s": num_envs * tcfg.num_steps / dt,
           "flood_launches": flood.launches()}
    if args.profile_dir:
        from active_tracking_rl_torch.run.profile_summary import \
            summarize_trace
        activity = (torch.profiler.ProfilerActivity.CUDA
                    if device.type == "cuda"
                    else torch.profiler.ProfilerActivity.CPU)
        with torch.profiler.profile(activities=[activity]) as prof:
            for _ in range(args.iters):
                carry, _, _ = step(carry, 0)
            sync()
        path = os.path.join(args.profile_dir,
                            f"trace-dp{mesh.world}-r{mesh.rank}.json")
        prof.export_chrome_trace(path)
        row["profile"] = summarize_trace(path, top=5)
    return row


def _worker(args) -> None:
    """One rank of a --dp value: one device, rank 0 prints the JSON row."""
    from active_tracking_rl_torch.parallel.mesh import (MeshSpec, host_init,
                                                        make_mesh, shutdown)
    from active_tracking_rl_torch.utils.platform import (default_backend,
                                                         pin_float32,
                                                         resolve_device)
    pin_float32()
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    device = resolve_device(args.device, args.process_id)
    host_init(args.coordinator, args.num_processes, args.process_id,
              default_backend(device), device, args.timeout)
    try:
        mesh = make_mesh(MeshSpec())
        print(json.dumps(bench_step(args, mesh, device)), flush=True)
    finally:
        shutdown()


def run_ranks(args, n: int) -> dict:
    """Spawn n ranks of one --dp value and return rank 0's row."""
    from active_tracking_rl_torch.parallel.mesh import free_port
    port = free_port()
    procs = []
    for r in range(n):
        cmd = [sys.executable, "-m", "active_tracking_rl_torch.parallel.scaling",
               "--worker", "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", str(n), "--process-id", str(r),
               "--envs-per-device", str(args.envs_per_device),
               "--iters", str(args.iters), "--env", args.env,
               "--network", args.network, "--device", args.device,
               "--timeout", str(args.timeout)]
        if args.profile_dir:
            cmd += ["--profile-dir", args.profile_dir]
        procs.append(subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=args.timeout))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, (_, err)) in enumerate(zip(procs, outs)):
        if pr.returncode != 0:
            raise RuntimeError(f"dp={n}: rank {r} exited {pr.returncode}:\n"
                               f"{err[-3000:]}")
    ranks = []
    for r, (out, err) in enumerate(outs):
        lines = [line for line in out.splitlines() if line.startswith("{")]
        if not lines:
            raise RuntimeError(f"dp={n}: rank {r} printed no result line:\n"
                               f"{err[-3000:]}")
        ranks.append(json.loads(lines[-1]))
    row = {k: v for k, v in ranks[0].items() if k != "profile"}
    row["rank_step_s"] = [rk["step_s"] for rk in ranks]
    if args.profile_dir:
        row["rank_profiles"] = [rk["profile"] for rk in ranks]
    return row


def scale(args) -> dict:
    """Every --dp value's row, then each row's weak-scaling efficiency."""
    avail = visible_devices(args.device)
    what = "CUDA device(s)" if args.device.startswith("cuda") else "CPU core(s)"
    rows = []
    for n in args.dp:
        if n > avail:
            rows.append({"dp": n, "skipped": f"> {avail} visible {what}"})
            continue
        rows.append(run_ranks(args, n))
    done = [r for r in rows if "env_steps_per_s" in r]
    if done:
        base = done[0]["env_steps_per_s"] / done[0]["dp"]
        for r in done:
            r["weak_scaling_eff"] = (r["env_steps_per_s"] / r["dp"]) / base
    return {"device": args.device, "visible_devices": avail,
            "envs_per_device": args.envs_per_device, "iters": args.iters,
            "env": args.env, "network": args.network, "rows": rows}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="weak scaling of the train step")
    p.add_argument("--dp", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--envs-per-device", type=int, default=1024)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--env", default="Track2D-BlockPartialNav-v0")
    p.add_argument("--network", default="maze-lstm")
    p.add_argument("--device", default="cuda",
                   help="cuda (rank r on cuda:r) or cpu")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds each --dp value's ranks may take")
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--profile-dir", default=None,
                   help="profile --iters more steps on every rank after the "
                        "timed ones; the traces go here")
    # one rank's flags (set by the harness)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=0,
                   help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.worker:
        _worker(args)
        return None
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
    out = scale(args)
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
