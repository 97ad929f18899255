"""Reads trainer runs' ``metrics.jsonl`` files (either package's CLI
writes them: the train scalars every 50 iterations, the eval scalars at
each checkpoint) and prints, per run, what the learning-parity records
keep: the success rate at every eval, the takeoff (the first eval with S
>= 0.5), where the tracker's ``train/entropies0`` first falls below 0.01
and where it next climbs above 0.1, the longest stretch below 0.01 before
the takeoff (an early collapse when it exceeds 300 iterations) and
``entropies0`` at chosen iterations, and with ``--bar S`` the first eval
with a success rate of at least S; with ``--rate`` the seconds an
iteration of each file (one chip call each, evaluations included, from
the train rows' ``wall``), and with ``--also KEY`` that scalar (for
example the target's ``train/entropies1``) at the ``--at`` iterations.
Imports only the standard library:

    python3 tests/learning_curves.py runs/r3-tracker-nav/*/*/metrics.jsonl \\
        --at 50 100 150 200 250 300 400

Files given as ``a.jsonl+b.jsonl`` are one run continued by ``--resume``
(joined by step).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

LOW, HIGH, TAKEOFF, EARLY = 0.01, 0.1, 0.5, 300
#: S is a float32 share of the episodes (95 of 100 logs 0.949999988)
S_ROUNDING = 1e-6


def load(spec: str) -> List[dict]:
    """The rows of one run, its files joined by step (a later file wins)."""
    rows: Dict[int, dict] = {}
    for path in spec.split("+"):
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                rows.setdefault(r["step"], {}).update(r)
    return [rows[k] for k in sorted(rows)]


def summary(rows: List[dict]) -> dict:
    ent = [(r["step"], r["train/entropies0"]) for r in rows
           if "train/entropies0" in r]
    evals = [(r["step"], r["test/success_rate"]) for r in rows
             if "test/success_rate" in r]
    takeoff = next((it for it, s in evals if s >= TAKEOFF), None)
    below = next((it for it, e in ent if e < LOW), None)
    above = (None if below is None else
             next((it for it, e in ent if it > below and e > HIGH), None))
    longest, start = 0, None
    end = takeoff if takeoff is not None else float("inf")
    for i, (it, e) in enumerate(ent):
        if it > end:
            break
        if e < LOW:
            start = it if start is None else start
            nxt = ent[i + 1][0] if i + 1 < len(ent) else it
            longest = max(longest, nxt - start)
        else:
            start = None
    return dict(evals=evals, takeoff=takeoff, first_below=below,
                back_above=above, longest_below=longest,
                early_collapse=longest > EARLY, entropy=dict(ent),
                last=ent[-1][0] if ent else None)


def rates(spec: str) -> List[Optional[float]]:
    """Seconds an iteration of each file of `spec`: the wall clock between
    its first and last train rows over the iterations between them."""
    out = []
    for path in spec.split("+"):
        with open(path) as f:
            tr = [r for r in map(json.loads, f)
                  if "train/entropies0" in r and "wall" in r]
        out.append((tr[-1]["wall"] - tr[0]["wall"])
                   / (tr[-1]["step"] - tr[0]["step"])
                   if len(tr) > 1 else None)
    return out


def values_at(rows: List[dict], key: str, at: List[int]) -> Dict[int, float]:
    """`key` at each of the iterations `at` that logged it."""
    have = {r["step"]: r[key] for r in rows if key in r}
    return {it: have[it] for it in at if it in have}


def first_at(evals, bar: float) -> Optional[int]:
    """The first eval's iteration with S >= bar (as a share of episodes)."""
    return next((it for it, x in evals if x >= bar - S_ROUNDING), None)


def line(name: str, s: dict, at: Optional[List[int]] = None,
         bar: Optional[float] = None) -> str:
    ev = " ".join(f"{x:.2f}" for _, x in s["evals"])
    out = (f"{name}: to {s['last']}; S [{ev}]; takeoff {s['takeoff']}; "
           f"entropies0 < {LOW} from {s['first_below']}, > {HIGH} again at "
           f"{s['back_above']}; longest below {LOW} before takeoff "
           f"{s['longest_below']} (early collapse: {s['early_collapse']})")
    if bar is not None:
        out += f"; first S >= {bar} at {first_at(s['evals'], bar)}"
    if at:
        out += "; entropies0 " + " ".join(
            f"{it}:{s['entropy'][it]:.4f}" for it in at if it in s["entropy"])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", help="metrics.jsonl (a+b: resumed)")
    ap.add_argument("--at", type=int, nargs="*", default=None,
                    help="also print entropies0 at these iterations")
    ap.add_argument("--bar", type=float, default=None,
                    help="also print the first eval with S >= this")
    ap.add_argument("--steps", action="store_true",
                    help="print each eval's iteration beside its S")
    ap.add_argument("--rate", action="store_true",
                    help="print each file's seconds an iteration")
    ap.add_argument("--also", action="append", default=[], metavar="KEY",
                    help="print this scalar at the --at iterations")
    args = ap.parse_args(argv)
    for spec in args.runs:
        rows = load(spec)
        s = summary(rows)
        print(line(spec, s, args.at, args.bar), flush=True)
        if args.steps:
            print("  S " + " ".join(f"{it}:{x:.2f}" for it, x in s["evals"]))
        if args.rate:
            print("  s/iter " + " ".join(
                "none" if r is None else f"{r:.4f}" for r in rates(spec)))
        for key in args.also:
            print(f"  {key} " + " ".join(
                f"{it}:{v:.4f}"
                for it, v in values_at(rows, key, args.at or []).items()))


if __name__ == "__main__":
    main()
