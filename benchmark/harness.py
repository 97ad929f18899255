"""The benchmark's loader and its run of one cell.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own, found by the name that ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the mix (``num_envs``, ``num_steps``,
  ``reset_pool``, ``pool_refresh``);
* ``metrics/<metric>.py``: the metric's reader, which declares ``UNIT``,
  ``SOURCE`` (and a per-layer one ``LAYER`` and ``MOVES``) and
  ``read(run) -> float | None``;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``.

``run_cell`` runs one cell in this process (``cell.py``), then the
metrics' readers, the comparison with the reference, and the result
line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: top-level modules that no run may load (the JAX package and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "active_tracking_rl_tpu")
#: the training steps that the reference follows
CHECKED_STEPS = 3


class BenchError(ValueError):
    """A benchmark file that breaks the benchmark's rules."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise BenchError(f"{what} {name!r}: a name is 1 to 64 letters, "
                         f"digits, '_', '.' and '-', not starting with "
                         f"'.' or '-'")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise BenchError(f"{what}: unit {unit!r} is not 1 to 16 letters, "
                         f"digits, '_', '/', '%', '.' and '-'")
    return unit


def _json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"{path} does not exist")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Reader:
    """A metric's reader module and its declarations."""

    name: str
    unit: str
    source: str
    layer: Optional[str]
    moves: Optional[str]
    read: object


def load_reader(root: Path, name: str) -> Reader:
    """``metrics/<name>.py``, loaded by its path."""
    check_name(name, "metric")
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return Reader(name, check_unit(mod.UNIT, f"metric {name}"), mod.SOURCE,
                  getattr(mod, "LAYER", None), getattr(mod, "MOVES", None),
                  mod.read)


@dataclasses.dataclass
class Cell:
    """One workload with everything its names point at."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Reader]
    per_layer: List[Reader]


def _applies(entry: dict, cell: str, reported: List[str]) -> bool:
    """Whether a metric belongs to `cell`: it lists the cell, or, without
    a list, its end-to-end metric is one that the cell reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def load_cell(workload: str, root: Path = HERE,
              bench_path: Optional[Path] = None) -> Cell:
    """The cell named `workload` of ``BENCHMARK.json``, its files found by
    name under `root`."""
    bench = _json(bench_path or root.parent / "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            check_name(entry["name"], key)
            if "unit" in entry:
                check_unit(entry["unit"], entry["name"])
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf, traffic_name = w["config"], check_name(w["traffic"], "traffic")
    if conf not in configs:
        raise BenchError(f"workload {workload}: no config {conf!r}")
    cfg = _json(root.parent / configs[conf]["file"])
    traffic = _json(root / "traffic" / f"{traffic_name}.json")
    limits = _json(root / "limits" / f"{workload}.json")
    e2e = [e for e in bench["end_to_end"] if _applies(e, workload, [])]
    reported = [e["name"] for e in e2e]
    per_layer = [e for e in bench["per_layer"]
                 if _applies(e, workload, reported)]
    readers = []
    for entries in (e2e, per_layer):
        group = []
        for e in entries:
            r = load_reader(root, e["name"])
            declared = {"unit": r.unit, "source": r.source}
            if e in per_layer:
                declared.update(layer=r.layer, moves=r.moves)
            for k, v in declared.items():
                if e.get(k) != v:
                    raise BenchError(f"metric {e['name']}: BENCHMARK.json "
                                     f"says {k} {e.get(k)!r}, its reader "
                                     f"{v!r}")
            group.append(r)
        readers.append(group)
    return Cell(workload, int(w["chips"]), conf, traffic_name, cfg, traffic,
                limits, *readers)


@dataclasses.dataclass
class Run:
    """What the readers read: the cell, the card, the timed window and, in
    a traced run, the reduced trace (``trace.reduce_events``)."""

    cfg: dict
    traffic: dict
    device_name: str
    peaks: Optional[dict]
    setup_s: float
    iters: int
    window_s: float
    #: env-steps a second
    rate: float
    trace: Optional[dict] = None
    traced_iters: int = 0

    @property
    def iters_per_s(self) -> float:
        return self.iters / self.window_s if self.window_s > 0 else 0.0


def peaks_for(device_name: str) -> Optional[dict]:
    """The card's peaks from ``peaks.json``; None for a card not in it."""
    return _json(HERE / "peaks.json").get(device_name)


def read_metrics(readers: List[Reader], run: Run) -> Dict[str, dict]:
    """Each reader's value; a reader that finds nothing is left out."""
    out = {}
    for r in readers:
        value = r.read(run)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            raise FloatingPointError(f"metric {r.name} read {value}")
        out[r.name] = {"value": value, "unit": r.unit}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    that no run may load."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def measure(cell: Cell, out: dict, reduced: Optional[dict]) -> None:
    """The cell's metrics from one process's `out` (and its reduced trace
    in a traced run) into ``out["metrics"]`` (``out["breakdown"]`` too in
    a traced run)."""
    run = Run(cell.cfg, cell.traffic, out["device_name"],
              peaks_for(out["device_name"]), out["setup_s"], out["iters"],
              out["window_s"], out["rate"], reduced,
              reduced["traced_iters"] if reduced else 0)
    out["metrics"] = read_metrics(
        cell.per_layer if reduced is not None else cell.end_to_end, run)
    if reduced is not None:
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}


def check_lines(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, dict]:
    """Each compared number beside its limit, in the limits file's order."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", variant: Optional[str] = None,
             root: Path = HERE, bench_path: Optional[Path] = None,
             t_start: Optional[float] = None) -> dict:
    """Run one cell and return its result object (the line's keys, with
    ``checks`` last). `device` "cpu" and `variant` (``faults.py``) are for
    the tests and the control: a result on the CPU is no measurement of
    the card."""
    import time
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload, root, bench_path)
    if cell.chips != 1:
        raise BenchError(f"{workload}: the harness runs one card a cell")
    from benchmark import cell as single
    out = single.run(cell, seed, seconds, trace, device, variant, t_start)
    metrics = out["metrics"]
    checks = check_lines(out["numbers"], cell.limits)
    correct = (out["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    device_info = {"platform": "gpu" if device.startswith("cuda") else
                   "cpu", "kind": out["device_name"], "count": out["count"],
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["iters"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if trace:
        device_info["busy_s"] = out["busy_s"]
        device_info["window_s"] = out["trace_window_s"]
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    result["_detail"] = out.get("detail", {})
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="run one benchmark cell on the "
                                "card and print its result line")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device is visible; this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded forbidden modules: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    detail = result.pop("_detail")
    for k, v in detail.items():
        print(f"[detail] {k}: {json.dumps(v)}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
