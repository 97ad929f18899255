"""The readings that the limits of ``correct`` are set from: the checked
first steps of the program on many seeds (sound runs), of the program in
its own bfloat16 path (the control) and of the program with each fault of
``faults.py`` planted, each against the reference from the same seed, at
the cell's own size. No window is run. The reference runs once a seed.

    python3 -m benchmark.control --workload tracker-nav.pool1.n16384 \
        --seeds 11 12 13 --variants none bf16 half_batch altered_action \
        --out chiprun_out/control.json

Prints one line a reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

from benchmark import harness


def readings(workload: str, jobs: List[Tuple[int, Optional[str]]],
             device: str = "cuda", root: Path = harness.HERE,
             bench_path: Optional[Path] = None) -> List[dict]:
    cell = harness.load_cell(workload, root, bench_path)
    import torch

    from benchmark import cell as single
    from benchmark import check, faults
    from benchmark.reference.learner import run_reference
    dev = torch.device(device)
    single.pin(dev)
    progs = []
    for seed, variant in jobs:
        tr = single.build(cell.cfg, cell.traffic, seed, dev,
                          bf16=variant == "bf16")
        undo = faults.plant(variant, tr)
        try:
            progs.append(single.first_steps(tr))
        finally:
            undo()
        del tr
        single.free()
    refs, out = {}, []
    for (seed, variant), prog in zip(jobs, progs):
        if seed not in refs:
            refs[seed] = run_reference(cell.cfg, cell.traffic, seed,
                                       harness.CHECKED_STEPS, dev,
                                       single.POOL_SEED)
        nums = check.numbers(prog, refs[seed])
        out.append({"seed": seed, "variant": variant,
                    "detail": nums.pop("_where"), "numbers": nums})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["none"],
                   help="none (a sound run) or a name of faults.VARIANTS")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    jobs = [(s, None if v == "none" else v) for s in args.seeds
            for v in args.variants]
    t0 = time.perf_counter()
    rows = readings(args.workload, jobs, args.device)
    for r in rows:
        print(json.dumps({"workload": args.workload, "seed": r["seed"],
                          "variant": r["variant"] or "none",
                          **r["numbers"]}), flush=True)
    print(f"[control] {args.workload}: {len(jobs)} readings in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "readings": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
