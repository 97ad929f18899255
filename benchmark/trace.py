"""Reduction of a ``torch.profiler`` Chrome trace, frozen here so that the
yardstick does not move with the program.

``sweep`` is the union sweep of ``active_tracking_rl_torch/run/
profile_summary.py`` (``_sweep``): the time covered by each category of
events, an instant counted once, for the highest-priority category active
there. ``reduce_events`` keeps what the per-layer metrics read: the traced
window (first start to last end of any complete event, as the program's
summary takes it), the device's busy time (the union of its kernels,
memcpys and memsets), each kernel name's total time and count, the kernels'
union per name substring, the launches the host made, the top device ops,
and the idle gaps named by the ``cpu_op`` the host was running in each.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: runtime calls that launch a kernel (cudaLaunchKernel, cudaLaunchKernelExC)
LAUNCH_PREFIX = "cudaLaunchKernel"


def sweep(intervals: Iterable[Tuple[float, float, int]], n_cats: int
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


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float,
              host_ops: List[dict]) -> Dict[str, float]:
    """Seconds of device idle time by the innermost ``cpu_op`` that a host
    thread was running at the middle of each gap (the newest-started op
    over the threads; "(no cpu_op)" where none ran)."""
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    ops = sorted(host_ops, key=lambda e: (e["ts"], -e["dur"]))
    stacks: Dict[tuple, list] = collections.defaultdict(list)
    out: Dict[str, float] = collections.defaultdict(float)
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(ops) and ops[i]["ts"] <= mid:
            e = ops[i]
            stack = stacks[e.get("pid"), e.get("tid")]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        best = None
        for stack in stacks.values():
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= mid:
                stack.pop()
            if stack and (best is None or stack[-1]["ts"] > best["ts"]):
                best = stack[-1]
        out[best["name"] if best else "(no cpu_op)"] += (b - a) / 1e6
    return dict(out)


def reduce_events(events: List[dict], top: int = 10,
                  name_width: int = 120) -> dict:
    """What the metrics read from one trace's events (times in seconds)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    for e in complete:
        e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
    lo = min(e["ts"] for e in complete)
    hi = max(e["ts"] + e["dur"] for e in complete)
    device = [e for e in complete if e.get("cat") in DEVICE_CATS]
    busy = merged([(e["ts"], e["ts"] + e["dur"]) for e in device])
    per_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    for e in device:
        acc = per_name[e["name"]]
        acc[0] += e["dur"] / 1e6
        acc[1] += 1
    launches = sum(1 for e in complete if e.get("cat") == "cuda_runtime"
                   and e["name"].startswith(LAUNCH_PREFIX))
    host_ops = [e for e in complete if e.get("cat") == "cpu_op"]
    gaps = idle_gaps(busy, lo, hi, host_ops)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": {n: {"s": v[0], "count": v[1]} for n, v in
                    per_name.items()},
        "intervals": [(e["ts"], e["ts"] + e["dur"], e["name"])
                      for e in device if e.get("cat") == "kernel"],
        "launches": launches,
        "device_ops": [[n[:name_width], v[0]] for n, v in ranked[:top]],
        "idle_gaps": sorted(([n[:name_width], s] for n, s in gaps.items()),
                            key=lambda x: -x[1])[:top],
    }


def kernel_union_s(reduced: dict, substring: str) -> float:
    """Seconds covered by the kernels whose names hold `substring` (case
    folded), their overlaps counted once."""
    sub = substring.lower()
    spans = merged([(a, b) for a, b, n in reduced["intervals"]
                    if sub in n.lower()])
    return sum(b - a for a, b in spans) / 1e6


def load(path: str) -> dict:
    with open(path) as f:
        trace = json.load(f)
    return reduce_events(trace["traceEvents"] if isinstance(trace, dict)
                         else trace)
