"""Where two runs of one seed part: two sessions of the port's trainer
(``run/train.py:setup``) built from the same flags in one process and
stepped in lockstep, one train step each per iteration, as
``run/train.py:run`` steps them at pool refresh 1.

    python3 tests/repro_parting.py --iters 60 --out parting.json -- \\
        --env Track2D-BlockPartialNav-v0 --env-base Track2D-BlockPartialNav-v0 \\
        --network maze-lstm --train-mode 0 --num-envs 256 --reset-pool 64

Run it from the root of the tree whose package it tests: it imports
``active_tracking_rl_torch`` from the working directory, so the same file
runs against another tree unpacked with ``git archive``. The flags after
``--`` are the trainer's (``--device`` defaults to cuda there).

After each iteration the parameters, the optimizer state, the carry (with
its generator's state) and the step's metrics of the two sessions are
compared bit for bit. At the first iteration where they differ, both
sessions go back to the state before it (equal in both) and run that
iteration again under a ``TorchDispatchMode`` that digests the output of
every aten op (two integer sums of its bits; allocations and views are
skipped), in the order the ops ran, the forward pass and the optimizer
first, then the backward pass; the first op whose outputs differ is the
first tensor that parts. A replay may happen to agree (the parting is a race): it is
tried up to ``--replays`` times. With ``--second-fills`` the second
session runs with ``torch.utils.deterministic.fill_uninitialized_memory``
on (the first with the setting its tree leaves): two such runs that never
part read no memory before writing it.

Prints one JSON object (and writes it to ``--out``): the iteration and
state entry where the runs first part (null if they never do), the first
op that parts, and the number of ops an iteration runs.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from same_run import first_difference, flat  # noqa: E402

INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
               8: torch.int64}


def digest(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of the bits of `t` (plain and position-weighted):
    integer sums, so their order does not change them."""
    b = t.detach().contiguous().reshape(-1)
    if b.dtype == torch.bool:
        b = b.to(torch.uint8)
    b = b.view(INT_OF_SIZE[b.element_size()]).to(torch.int64)
    w = torch.arange(1, b.numel() + 1, device=b.device, dtype=torch.int64)
    return torch.stack([b.sum(), (b * w).sum()])


class OpDigests(TorchDispatchMode):
    """Records (op, pass, output index, shape) and a digest of each tensor
    that each aten op returns."""

    def __init__(self):
        super().__init__()
        self.ops, self.sums = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        # an allocation holds no value yet; a view holds its base's bytes,
        # and one taken to be written (tape[:, t] = a) holds them unwritten
        if func.is_view or name.split(".")[1].startswith(("empty",
                                                         "new_empty")):
            return out
        node = torch._C._current_autograd_node()
        where = "forward" if node is None else f"backward:{node.name()}"
        for i, t in enumerate(tree_flatten(out)[0]):
            if (isinstance(t, torch.Tensor) and t.numel()
                    and not t.is_complex() and t.layout == torch.strided):
                self.ops.append((name, where, i, list(t.shape)))
                self.sums.append(digest(t))
        return out

    def table(self):
        return (torch.stack([d.cpu() for d in self.sums]) if self.sums
                else None)


def snapshot(train_mod, s, metrics=None):
    """A copy of what one iteration leaves: parameters, optimizer state,
    carry, curriculum and, if given, the step's metrics."""
    state = {"model": s.model.state_dict(), "optimizer": s.opt.state_dict(),
             "carry": train_mod.carry_state(s.carry)}
    if metrics is not None:
        state["metrics"] = dict(zip(metrics._fields, metrics))
    state = copy.deepcopy(state)
    state["cur"] = s.cur
    return state


def restore(train_mod, s, snap):
    s.model.load_state_dict(snap["model"])
    s.opt.load_state_dict(copy.deepcopy(snap["optimizer"]))
    s.carry = train_mod.restore_carry(copy.deepcopy(snap["carry"]),
                                      s.carry.generator)
    s.cur = snap["cur"]


def step_once(s, step, it, fills):
    """One iteration of run/train.py's loop at pool refresh 1."""
    from active_tracking_rl_torch.rl import curriculum
    torch.utils.deterministic.fill_uninitialized_memory = fills
    s.cur = curriculum.update(s.tcfg, s.cur, it)
    s.carry, m, _ = step(s.carry, s.cur.mode)
    return m


def first_op_parting(train_mod, sessions, steps, snap, it, fills):
    """Replays iteration `it` from `snap` in both sessions under OpDigests;
    the first op whose outputs differ, or None if this replay agrees."""
    tables, records = [], []
    for s, step, fill in zip(sessions, steps, fills):
        restore(train_mod, s, snap)
        rec = OpDigests()
        with rec:
            step_once(s, step, it, fill)
        tables.append(rec.table())
        records.append(rec.ops)
    if records[0] != records[1]:
        k = next(i for i, (x, y) in enumerate(zip(*records)) if x != y)
        return {"op_sequences_differ_at": k, "ops": [records[0][k],
                                                     records[1][k]]}
    bad = (tables[0] != tables[1]).any(1).nonzero().flatten().tolist()
    if not bad:
        return None
    first_bwd = next((i for i in bad
                      if records[0][i][1].startswith("backward")), None)
    return {"index": bad[0], "op": records[0][bad[0]],
            "ops_in_iteration": len(records[0]), "ops_parted": len(bad),
            "first_forward_parted": next(
                (records[0][i] for i in bad
                 if not records[0][i][1].startswith("backward")), None),
            "first_backward_parted": (None if first_bwd is None else
                                      [first_bwd, records[0][first_bwd]])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--replays", type=int, default=3)
    ap.add_argument("--second-fills", action="store_true",
                    help="run the second session with "
                         "fill_uninitialized_memory on")
    ap.add_argument("--out", default=None)
    ap.add_argument("flags", nargs=argparse.REMAINDER,
                    help="-- then the trainer's flags")
    args = ap.parse_args(argv)
    flags = [f for f in args.flags if f != "--"]
    from active_tracking_rl_torch.rl.learner import make_train_step
    from active_tracking_rl_torch.run import train as train_mod
    t0 = time.time()
    tmp = tempfile.mkdtemp()
    sessions = [train_mod.setup(flags + ["--log-dir", tmp, "--run-name", n])
                for n in ("a", "b")]
    if sessions[0].args.pool_refresh != 1:
        raise SystemExit("only --pool-refresh 1 is stepped here")
    base_fill = bool(torch.utils.deterministic.fill_uninitialized_memory)
    fills = (base_fill, args.second_fills or base_fill)
    steps = [make_train_step(s.model, s.env, s.ncfg, s.tcfg, s.opt,
                             mesh=s.mesh) for s in sessions]
    out = {"tree": os.getcwd(), "flags": flags, "torch": torch.__version__,
           "device": str(sessions[0].device),
           "deterministic_algorithms":
               torch.are_deterministic_algorithms_enabled(),
           "fill_uninitialized_memory": fills, "iters": args.iters,
           "parted_at": None, "first_difference": None, "first_op": None,
           "replays": 0}
    if sessions[0].device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(sessions[0].device)
    before = snapshot(train_mod, sessions[0])
    for it in range(1, args.iters + 1):
        ends = [snapshot(train_mod, s, step_once(s, step, it, fill))
                for s, step, fill in zip(sessions, steps, fills)]
        diff = first_difference(*(dict(flat(e)) for e in ends))
        if diff is None:
            before = ends[0]
            continue
        out["parted_at"], out["first_difference"] = it, diff
        for r in range(args.replays):
            out["replays"] = r + 1
            out["first_op"] = first_op_parting(train_mod, sessions, steps,
                                               before, it, fills)
            if out["first_op"] is not None:
                break
        break
    out["seconds"] = round(time.time() - t0, 3)
    for s in sessions:
        train_mod.close_logger(s.log)
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
