"""Op-level summary of a ``torch.profiler`` trace of the train step.

The port's counterpart of ``active_tracking_rl_tpu/run/xprof_summary.py``,
which reduces a ``jax.profiler`` trace with xprof's ``hlo_stats``. Here the
trace is the Chrome trace that ``torch.profiler`` exports (``trace.json``,
as ``run/train.py --profile-dir`` writes it), and :func:`summarize_trace`
reduces it to JSON:

* on a trace with device events (CUDA kernels, memcpys, memsets): the
  total device time (the sum of the device events' durations, as xprof
  sums self times), the device's busy time (their union) and the traced
  window; the shares of the window that are kernel, memcpy, memset and
  idle (where events overlap, a kernel counts before a memcpy and a memcpy
  before a memset, so the four shares sum to 1); the top ops by total time,
  each with its share of the device time, its count and its name;
* on a CPU trace (no device events): the same over the ``cpu_op`` events,
  each op timed by its self time (its duration less its nested ops'), the
  shares ``cpu_op`` (the union of their intervals) and ``idle``.

The traced window runs from the first to the last end of any complete event
(the profiler's own span included).

Usage:
    # capture the main train step on a given pool on the card, then summarize:
    python -m active_tracking_rl_torch.run.profile_summary --capture
    # summarize a trace dir written by run/train.py --profile-dir:
    python -m active_tracking_rl_torch.run.profile_summary --trace-dir logs/prof
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import shutil
from typing import Dict, List, Tuple

import torch

from active_tracking_rl_torch.ops import noise

#: the device event categories of a torch.profiler trace, by priority
DEVICE_CATEGORIES = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                     "gpu_memset": "memset"}


def _sweep(intervals: List[Tuple[float, float, int]], n_cats: int
           ) -> List[float]:
    """Time covered by each category (index = priority, 0 first) when every
    covered instant goes to the highest-priority category active there."""
    points = []
    for start, end, cat in intervals:
        if end > start:
            points.append((start, 1, cat))
            points.append((end, -1, cat))
    points.sort()
    active = [0] * n_cats
    covered = [0.0] * n_cats
    last = None
    for t, delta, cat in points:
        if last is not None and t > last:
            for c in range(n_cats):
                if active[c]:
                    covered[c] += t - last
                    break
        active[cat] += delta
        last = t
    return covered


def _self_times(events: List[dict]) -> List[float]:
    """Each event's duration less that of the events nested directly in it
    on its thread."""
    self_t = [float(e["dur"]) for e in events]
    by_thread = collections.defaultdict(list)
    for i, e in enumerate(events):
        by_thread[e.get("pid"), e.get("tid")].append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (events[i]["ts"], -events[i]["dur"]))
        stack: List[int] = []
        for i in idx:
            ts = events[i]["ts"]
            while stack and (events[stack[-1]]["ts"]
                             + events[stack[-1]]["dur"]) <= ts:
                stack.pop()
            if stack:
                self_t[stack[-1]] -= events[i]["dur"]
            stack.append(i)
    return [max(t, 0.0) for t in self_t]


def _trace_path(trace_dir: str) -> str:
    if os.path.isfile(trace_dir):
        return trace_dir
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {trace_dir}")
    return paths[-1]


def summarize_events(events: List[dict], top: int = 15) -> Dict:
    """The summary of a Chrome trace's events (times in ms)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if not complete:
        raise ValueError("the trace holds no complete events")
    lo = min(float(e["ts"]) for e in complete)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in complete)
    window = hi - lo
    device = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    if device:
        mode, ops = "device", device
        names = list(dict.fromkeys(DEVICE_CATEGORIES.values()))
        cat_of = {k: names.index(v) for k, v in DEVICE_CATEGORIES.items()}
        covered = _sweep([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           cat_of[e["cat"]]) for e in device], len(names))
        times = [float(e["dur"]) for e in device]
    else:
        mode = "cpu"
        ops = [e for e in complete if e.get("cat") == "cpu_op"]
        if not ops:
            raise ValueError("the trace holds no device and no cpu_op events")
        names = ["cpu_op"]
        covered = _sweep([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           0) for e in ops], 1)
        times = _self_times(ops)
    busy = sum(covered)
    total = sum(times)
    shares = {n: c / window for n, c in zip(names, covered)}
    shares["idle"] = (window - busy) / window
    per_op = collections.defaultdict(lambda: [0.0, 0, ""])
    for e, t in zip(ops, times):
        acc = per_op[e["name"]]
        acc[0] += t
        acc[1] += 1
        acc[2] = DEVICE_CATEGORIES.get(e.get("cat"), e.get("cat"))
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "mode": mode,
        "window_ms": window / 1e3,
        "busy_ms": busy / 1e3,
        ("total_device_ms" if mode == "device" else "total_cpu_ms"):
            total / 1e3,
        "op_events": len(ops),
        "categories": shares,
        "top_ops": [{"name": name, "category": cat, "ms": t / 1e3,
                     "share": t / total if total else 0.0, "count": n}
                    for name, (t, n, cat) in ranked],
    }


def summarize_trace(trace_dir: str, top: int = 15) -> Dict:
    """Summarize the newest Chrome trace under `trace_dir` (or that file)."""
    path = _trace_path(trace_dir)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return {"trace": path, **summarize_events(events, top)}


def capture(num_envs: int, iters: int, env_id: str, network: str,
            out_dir: str, device="cuda", remat: bool = True) -> str:
    """Profile `iters` train steps on a given pool (after 2 untimed ones)
    and write ``out_dir/trace.json``; returns `out_dir`. As the JAX
    capture: train mode 0, a pool of max(num_envs // 8, 64) reused at
    pointer 0, remat on (the JAX trainer CLI's default); `remat` False
    profiles the port's default train step instead."""
    from active_tracking_rl_torch.config import (NetConfig, TrainConfig,
                                                 parse_env_id)
    from active_tracking_rl_torch.envs.env import TrackEnv
    from active_tracking_rl_torch.models.dueling import build_model
    from active_tracking_rl_torch.rl.learner import (init_learner,
                                                     init_pool_ptr,
                                                     make_pool_fn,
                                                     make_train_step)
    from active_tracking_rl_torch.utils.platform import (pin_float32,
                                                         resolve_device, sync)

    pin_float32()
    dev = resolve_device(device)
    tcfg = TrainConfig(env_id=env_id, num_envs=num_envs,
                       reset_pool=max(num_envs // 8, 64), train_mode=0,
                       remat=remat)
    ncfg = NetConfig.from_name(network, aux="none")
    ecfg = parse_env_id(env_id)
    env = TrackEnv(ecfg, dev)
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, device=dev)
    state = init_learner(model, env, ncfg, tcfg,
                         noise.generator(0, dev))
    pool = (*make_pool_fn(env, tcfg)(
        noise.generator(9, dev)),
        init_pool_ptr(device=dev))
    step = make_train_step(model, env, ncfg, tcfg, state.opt)
    carry = state.carry

    for _ in range(2):
        carry, m, _ = step(carry, 0, pool)
    sync(dev)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            carry, m, _ = step(carry, 0, pool)
        sync(dev)
    if not torch.isfinite(m.loss):
        raise FloatingPointError("non-finite loss in the captured steps")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    return out_dir


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="summarize a torch.profiler "
                                 "trace of the train step")
    ap.add_argument("--trace-dir", default="logs/profile",
                    help="trace dir (or trace file) to summarize; "
                         "--capture writes its trace.json here")
    ap.add_argument("--capture", action="store_true",
                    help="capture a fresh trace of the main train step first")
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--env", default="Track2D-BlockPartialNav-v0")
    ap.add_argument("--network", default="maze-lstm")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --capture (default cuda)")
    ap.add_argument("--no-remat", action="store_true",
                    help="--capture the train step with remat off (the "
                         "port's trainer default) instead of on (JAX's)")
    ap.add_argument("--top", type=int, default=15)
    return ap


def main(argv=None) -> Dict:
    args = build_argparser().parse_args(argv)
    if args.capture:
        shutil.rmtree(args.trace_dir, ignore_errors=True)
        capture(args.num_envs, args.iters, args.env, args.network,
                args.trace_dir, args.device, remat=not args.no_remat)
    out = summarize_trace(args.trace_dir, args.top)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
