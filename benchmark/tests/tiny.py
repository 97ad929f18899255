"""A copy of the benchmark's files with tiny cells, for CPU tests: the
real configurations, readers and peaks, tiny traffic mixes, and each tiny
cell held to the limits of the real cell it stands for."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

#: tiny cell -> (configuration, the real cell whose limits it takes,
#: traffic)
TINY = {
    "tracker-nav.tiny1": ("tracker-nav", "tracker-nav.pool1.n16384",
                          {"num_envs": 16, "num_steps": 4, "reset_pool": 8,
                           "pool_refresh": 1}),
    "advat.tiny2": ("advat", "advat.pool16.n16384",
                    {"num_envs": 16, "num_steps": 4, "reset_pool": 8,
                     "pool_refresh": 2}),
}


def make(tmp: Path) -> tuple:
    """(root, BENCHMARK.json path) of a copy under `tmp` with the tiny
    cells."""
    root = tmp / "benchmark"
    for sub in ("configs", "metrics", "traffic", "limits"):
        shutil.copytree(harness.HERE / sub, root / sub)
    shutil.copy(harness.HERE / "peaks.json", root / "peaks.json")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = []
    for name, (conf, real, traffic) in TINY.items():
        tname = name.split(".", 1)[1]
        (root / "traffic" / f"{tname}.json").write_text(json.dumps(traffic))
        shutil.copy(root / "limits" / f"{real}.json",
                    root / "limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": tname,
                                   "chips": 1, "why": "tiny"})
    for e in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in e:
            e["workloads"] = list(TINY)
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return root, path
