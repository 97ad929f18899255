"""Packs learning runs' ``train_state.pt`` for the trip back from a chip
call: the state of the highest iteration that loads (a run cut by
``timeout -s INT`` in the middle of a save leaves a broken file; a copy
``train_state*.pt`` beside it is tried too), lzma-compressed, with each
run's ``metrics.jsonl``, ``logger`` and ``ckpt_meta.json``, in the order
given, leaving out the states that would take the output over a cap::

    python3 tests/pack_states.py LOG_DIR OUT CAP_MIB run-a run-b ...

writes ``OUT/states/<run>.<iteration>.pt.xz`` and ``OUT/runs/<run>/``,
printing one ``PACK`` line a run. A call's output may bring back 64 MiB;
at 1024 envs a tat-maze-lstm Nav state packs to 7.7-8.2 MiB (stack-4:
16.0-16.6 MiB).
``tests/torch_to_jax.py:load_state_file`` reads a packed state;
``python3 tests/pack_states.py --unpack S.pt.xz DIR`` restores
``DIR/train_state.pt`` for ``--resume DIR``; ``python3
tests/pack_states.py --players S.pt.xz DIR [NETWORK]`` writes the state's
parameters as ``DIR/tracker-<iteration>.msgpack`` and
``target-<iteration>.msgpack``, the trainer's checkpoint format, for
``run/eval_matrix.py`` (NETWORK: the run's ``--network``, default
tat-maze-lstm). Imports the standard library and torch (``--players``
also the port).
"""

from __future__ import annotations

import glob
import io
import lzma
import os
import shutil
import sys

import torch

KEEP = ("metrics.jsonl", "logger", "ckpt_meta.json")


def used_mib(out: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(out) for f in fs) / 2 ** 20


def newest_state(run_dir: str):
    """(iteration, path) of the highest-iteration state that loads."""
    best = None
    for path in glob.glob(os.path.join(run_dir, "train_state*.pt")):
        try:
            state = torch.load(path, map_location="cpu", weights_only=True)
            step = int(state["state"]["step"])
        except Exception as e:           # a file cut mid-write
            print(f"PACK {path} does not load: {e!r}")
            continue
        if best is None or step > best[0]:
            best = (step, path)
    return best


def write_players(src: str, dst: str, network: str = "tat-maze-lstm"):
    """The packed state's tracker and target in the trainer's format;
    returns the two paths."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from active_tracking_rl_torch.config import NetConfig
    from active_tracking_rl_torch.models.dueling import params_to_flax
    from active_tracking_rl_torch.rl.checkpoint import save_file
    with open(src, "rb") as f:
        state = torch.load(io.BytesIO(lzma.decompress(f.read())),
                           map_location="cpu", weights_only=True)["state"]
    tree = params_to_flax(state["model"], NetConfig.from_name(network))
    paths = []
    for name, player in (("tracker", "player0"), ("target", "player1")):
        paths.append(os.path.join(dst, f"{name}-{int(state['step'])}.msgpack"))
        save_file(paths[-1], tree[player])
    return paths


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if argv[0] == "--players":
        print("PLAYERS", *write_players(*argv[1:]))
        return 0
    if argv[0] == "--unpack":
        src, dst = argv[1:]
        os.makedirs(dst, exist_ok=True)
        with open(src, "rb") as f, open(os.path.join(dst, "train_state.pt"),
                                        "wb") as g:
            g.write(lzma.decompress(f.read()))
        return 0
    log_dir, out, cap, *names = argv
    os.makedirs(os.path.join(out, "states"), exist_ok=True)
    for name in names:
        dirs = glob.glob(os.path.join(log_dir, "*", name))
        if not dirs:
            print(f"PACK {name}: no run dir")
            continue
        rec = os.path.join(out, "runs", name)
        os.makedirs(rec, exist_ok=True)
        for k in KEEP:
            if os.path.exists(os.path.join(dirs[0], k)):
                shutil.copy(os.path.join(dirs[0], k), os.path.join(rec, k))
        best = newest_state(dirs[0])
        if best is None:
            print(f"PACK {name}: no state")
            continue
        step, path = best
        with open(path, "rb") as f:
            packed = lzma.compress(f.read(), preset=6)
        mib = len(packed) / 2 ** 20
        if used_mib(out) + mib > float(cap):
            print(f"PACK {name}: LEFT OUT (iteration {step}, {mib:.1f} MiB)")
            continue
        with open(os.path.join(out, "states", f"{name}.{step}.pt.xz"),
                  "wb") as f:
            f.write(packed)
        print(f"PACK {name}: iteration {step}, {mib:.1f} MiB")
    print(f"PACK total {used_mib(out):.1f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
