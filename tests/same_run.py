"""Whether trainer runs are one run: their saved states and logs, bit for
bit.

    python3 tests/same_run.py WANT GOT [GOT ...] [--out same.json]

WANT and each GOT are run dirs of ``run/train.py`` (``train_state.pt``,
``metrics.jsonl``); a GOT written ``HALF+RESUMED`` is a run split by
``--resume``: HALF's log up to its last iteration (less the evaluation
where it stopped, which WANT need not have made) joined to RESUMED's, and
RESUMED's state. Two runs are the same when their parameters, optimizer
state and carry (with its generator's state) are equal bit for bit, and
so is every metrics.jsonl line but its wall-clock fields (``wall``,
``train/fps``). Prints one JSON object, each GOT with ``same`` and, if
not, the first entry that differs; exits 1 unless every GOT is WANT.
Run it from the root of the repository (it imports the port's checkpoint
reader).

    python3 tests/same_run.py --prefix WANT GOT [GOT ...]

compares logs only: GOT (or a chain ``A+B+C`` of a run and its
``--resume`` continuations, each ending at an evaluation) is a prefix of
WANT when its metrics.jsonl lines equal WANT's lines up to GOT's last
step, but for the wall-clock fields. A run of one seed to an earlier
``--total-iters`` is such a prefix: evaluations do not change the
training trajectory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

WALL_CLOCK = ("wall", "train/fps")
PARTS = ("model", "optimizer", "carry")


def metric_lines(run_dir):
    with open(Path(run_dir) / "metrics.jsonl") as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in WALL_CLOCK} for line in f]


def flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{path}/{i}")
    else:
        yield path, tree


def state(run_dir):
    from active_tracking_rl_torch.rl.checkpoint import load_train_state
    saved = load_train_state(str(run_dir))
    return dict(flat({k: saved[k] for k in PARTS})), saved["step"]


def first_difference(got, want):
    if list(got) != list(want):
        return {"entry": "keys", "got": len(got), "want": len(want)}
    for name, w in want.items():
        g = got[name]
        if torch.is_tensor(w):
            if g.dtype != w.dtype or not torch.equal(g, w):
                gap = ((g.double() - w.double()).abs().max().item()
                       if w.is_floating_point() else None)
                return {"entry": name, "max_abs_diff": gap}
        elif g != w:
            return {"entry": name, "got": str(g), "want": str(w)}
    return None


def compare(want_dir, got_spec):
    want_state, want_step = state(want_dir)
    want_lines = metric_lines(want_dir)
    if "+" in got_spec:
        half, resumed = got_spec.split("+")
        first = metric_lines(half)
        last = max(r["step"] for r in first)
        lines = [r for r in first if not (r["step"] == last
                                          and "test/success_rate" in r)]
        lines += metric_lines(resumed)
        got_dir = resumed
    else:
        lines, got_dir = metric_lines(got_spec), got_spec
    got_state, got_step = state(got_dir)
    out = {"got": got_spec, "step": got_step, "lines": len(lines)}
    if got_step != want_step:
        out["difference"] = {"entry": "step", "got": got_step,
                             "want": want_step}
    elif lines != want_lines:
        k = next((i for i, (a, b) in enumerate(zip(lines, want_lines))
                  if a != b), min(len(lines), len(want_lines)))
        out["difference"] = {"entry": f"metrics line {k}",
                             "got": lines[k] if k < len(lines) else None,
                             "want": want_lines[k] if k < len(want_lines)
                             else None}
    else:
        out["difference"] = first_difference(got_state, want_state)
    out["same"] = out["difference"] is None
    return out


def compare_prefix(want_dir, got_spec):
    lines = [r for d in got_spec.split("+") for r in metric_lines(d)]
    last = max(r["step"] for r in lines)
    want = [r for r in metric_lines(want_dir) if r["step"] <= last]
    out = {"got": got_spec, "step": last, "lines": len(lines),
           "difference": None}
    if lines != want:
        k = next((i for i, (a, b) in enumerate(zip(lines, want)) if a != b),
                 min(len(lines), len(want)))
        out["difference"] = {"entry": f"metrics line {k}",
                             "got": lines[k] if k < len(lines) else None,
                             "want": want[k] if k < len(want) else None}
    out["same"] = out["difference"] is None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("want")
    ap.add_argument("got", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--prefix", action="store_true",
                    help="compare the logs of GOT with WANT's first lines")
    args = ap.parse_args(argv)
    check = compare_prefix if args.prefix else compare
    res = {"want": args.want, "runs": [check(args.want, g)
                                       for g in args.got]}
    res["all_same"] = all(r["same"] for r in res["runs"])
    text = json.dumps(res)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if res["all_same"] else 1


if __name__ == "__main__":
    sys.exit(main())
