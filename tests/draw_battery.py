"""Joint statistics of the train steps' sampling noise, as production
draws it: a diagnostic script, not a test.

For each generator and seed it replays what the trainer's carry generator
draws (the initial parameters, the env carry's reset draws, then each
iteration's ``(T, B, 2, A)`` action noise and ``(B, A)`` bootstrap noise)
for the first ``--iters`` iterations of a run of the given
``run/train.py`` flags. The generators: ``cuda`` and ``cpu``, the port's
(``ops/noise.py``'s threefry2x32, drawing on that device), and
``torch-cuda`` and ``torch-cpu``, a ``torch.Generator`` on that device
(Philox on the card, mt19937 on the CPU) drawing as the port drew before
threefry2x32: ``torch.rand``, ``torch.randint`` and ``argsort`` of
``torch.rand`` keys in the same calls, order and shapes, so the streams
are those of the port's production at ``f8e7a8b``. It prints, as one JSON
line per generator and seed:

- the lag-1 correlation of the action noise along ``t``, along
  iterations, across rows ``b``, across the two players and across
  adjacent actions, each with its z = r sqrt(n) (about N(0, 1) for
  independent draws), and of the bootstrap noise along iterations and
  across rows;
- under fixed saturated logits (the first action ``gap`` above the
  others, gaps 6 and 8), the count of exploratory actions (argmax of
  logits + noise not the first) of each row and player in each rollout,
  against Binomial(T, q): the overdispersion chi-square over the rows,
  its degrees of freedom and z = (X - df) / sqrt(2 df), and the total
  count's z.

    python tests/draw_battery.py --generators torch-cuda,torch-cpu,cuda \\
        --seeds 11-14 --iters 50 --out battery.json -- <run/train.py flags>

Imports only the port (run it on the card's machine from the repository
root).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def seeds_arg(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def corr(a: np.ndarray, b: np.ndarray) -> dict:
    a = a.ravel().astype(np.float64)
    b = b.ravel().astype(np.float64)
    r = float(np.corrcoef(a, b)[0, 1])
    return {"r": r, "z": r * math.sqrt(a.size), "n": int(a.size)}


def overdispersion(counts: np.ndarray, trials: int, q: float) -> dict:
    """Counts that should be Binomial(trials, q), one per row."""
    c = counts.ravel().astype(np.float64)
    var = trials * q * (1 - q)
    x = float(((c - trials * q) ** 2).sum() / var)
    df = c.size
    total_z = float((c.sum() - df * trials * q) / math.sqrt(df * var))
    return {"chi2": x, "df": df, "z": (x - df) / math.sqrt(2 * df),
            "mean": float(c.mean()), "expected": trials * q,
            "total_z": total_z}


class TorchDraws:
    """ops/noise.py's draw functions on a ``torch.Generator``, as the port
    made them before threefry2x32 (``rows`` is always None on these
    paths)."""

    def __init__(self, noise):
        self.noise = noise
        self.saved = {k: getattr(noise, k) for k in
                      ("uniform", "gumbel", "randint", "permutations")}

    def __enter__(self):
        tiny = torch.finfo(torch.float32).tiny

        def uniform(shape, generator, device=None, low=0.0, high=1.0,
                    rows=None, dim=0):
            u = torch.rand(shape, generator=generator, device=device)
            return u if (low, high) == (0.0, 1.0) else u * (high - low) + low

        def gumbel(shape, generator, device=None, rows=None, dim=0):
            u = torch.rand(shape, generator=generator, device=device)
            return -torch.log(-torch.log(u.clamp_min_(tiny)))

        def randint(high, shape, generator, device=None, dtype=torch.int64,
                    rows=None):
            return torch.randint(0, high, shape, generator=generator,
                                 device=device, dtype=dtype)

        def permutations(n_rows, n, generator, device=None, rows=None):
            return torch.argsort(torch.rand((n_rows, n), generator=generator,
                                            device=device), dim=-1)

        for k, fn in (("uniform", uniform), ("gumbel", gumbel),
                      ("randint", randint), ("permutations", permutations)):
            setattr(self.noise, k, fn)
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.noise, k, fn)


def record(train_args, generator: str, seed: int, iters: int):
    """The carry generator's draws of the first `iters` iterations:
    action noise (iters, T, B, 2, A) and bootstrap noise (iters, B, A),
    both float32 on the CPU."""
    import contextlib

    from active_tracking_rl_torch.config import parse_env_id
    from active_tracking_rl_torch.envs.env import TrackEnv
    from active_tracking_rl_torch.models.dueling import build_model
    from active_tracking_rl_torch.ops import noise
    from active_tracking_rl_torch.rl import learner
    from active_tracking_rl_torch.run import train

    args = train.build_argparser().parse_args(train_args)
    tcfg = train.train_config_from_args(args)
    ncfg = train.net_config_from_args(args, tcfg)
    ecfg = parse_env_id(tcfg.env_id)
    legacy = generator.startswith("torch-")
    dev = torch.device(generator[len("torch-"):] if legacy else generator)
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, device=dev)
    gen = (torch.Generator(device=dev).manual_seed(seed) if legacy
           else noise.generator(seed, dev))
    with TorchDraws(noise) if legacy else contextlib.nullcontext():
        model.reset_parameters(gen)
        TrackEnv(ecfg, dev).draw_reset(tcfg.num_envs, gen)
        acts, boots = [], []
        for _ in range(iters):
            n = learner.draw_step_noise(tcfg.num_steps, tcfg.num_envs,
                                        ecfg.num_actions, gen, dev)
            acts.append(n.actions.cpu())
            boots.append(n.bootstrap.cpu())
    return torch.stack(acts).numpy(), torch.stack(boots).numpy()


def battery(act: np.ndarray, boot: np.ndarray) -> dict:
    out = {
        "act_t": corr(act[:, :-1], act[:, 1:]),
        "act_iter": corr(act[:-1], act[1:]),
        "act_b": corr(act[:, :, :-1], act[:, :, 1:]),
        "act_player": corr(act[..., 0, :], act[..., 1, :]),
        "act_action": corr(act[..., :-1], act[..., 1:]),
        "boot_iter": corr(boot[:-1], boot[1:]),
        "boot_b": corr(boot[:, :-1], boot[:, 1:]),
        "act_mean": float(act.mean()), "act_std": float(act.std()),
    }
    a = act.shape[-1]
    t = act.shape[1]
    for gap in (6.0, 8.0):
        logits = np.zeros(a, np.float32)
        logits[0] = gap
        q = (a - 1) / (math.exp(gap) + a - 1)
        explore = np.argmax(act + logits, axis=-1) != 0   # (I, T, B, 2)
        out[f"gap{gap:g}_rows"] = overdispersion(explore.sum(1), t, q)
        out[f"gap{gap:g}_tracker_rows"] = overdispersion(
            explore[..., 0].sum(1), t, q)
        bexp = np.argmax(boot + logits, axis=-1) != 0       # (I, B)
        out[f"gap{gap:g}_boot_rows"] = overdispersion(
            bexp.sum(0), boot.shape[0], q)
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--generators", default="torch-cuda,torch-cpu,cuda")
    ap.add_argument("--seeds", type=seeds_arg, default=seeds_arg("11-14"))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv[:split])
    torch.set_num_threads(1)
    results = []
    for dev in args.generators.split(","):
        for seed in args.seeds:
            act, boot = record(argv[split + 1:], dev, seed, args.iters)
            row = {"generator": dev, "seed": seed, **battery(act, boot)}
            results.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
