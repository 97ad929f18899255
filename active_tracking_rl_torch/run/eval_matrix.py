"""Evaluation matrix in one process: every tracker x every env.

Port of ``active_tracking_rl_tpu/run/eval_matrix.py``. Each cell pools
`--eval-seeds` greedy evaluations of `--num-episodes` episodes (seeds
`--seed` + 101 s) and reports the mean return with a 95% normal interval
and the success rate with its Wilson interval; learned targets (`--target`)
play every tracker on `--adv-env`. `--center-full-obs` evaluates with the
Full-obs centering training aid. `--out` writes the whole matrix as JSON.

    python -m active_tracking_rl_torch.run.eval_matrix \\
        --tracker ram=runs/.../tracker-best.msgpack \\
        --env Track2D-BlockPartialRam-v0 --out matrix.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from active_tracking_rl_torch.config import NetConfig, parse_env_id
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import build_model
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.rl.checkpoint import load_params
from active_tracking_rl_torch.rl.evaluate import make_evaluator
from active_tracking_rl_torch.utils.platform import pin_float32
from active_tracking_rl_torch.utils.stats import wilson_ci

PAPER_ENVS = [
    "Track2D-BlockPartialNav-v0",
    "Track2D-BlockPartialRam-v0",
    "Track2D-MazePartialNav-v0",
    "Track2D-MazePartialRam-v0",
]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="evaluation matrix (PyTorch)")
    p.add_argument("--tracker", action="append", required=True,
                   help="name=path/to/tracker-best.msgpack (repeatable)")
    p.add_argument("--target", action="append", default=[],
                   help="name=path to a learned target; evaluated against "
                        "every tracker on --adv-env")
    p.add_argument("--env", action="append", default=None,
                   help="env id (repeatable; default: the 4 paper envs)")
    p.add_argument("--adv-env", default="Track2D-BlockPartialAdv-v0")
    p.add_argument("--network", default="tat-maze-lstm")
    p.add_argument("--num-episodes", type=int, default=100)
    p.add_argument("--eval-seeds", type=int, default=3,
                   help="independent eval seeds per cell; episodes pool "
                        "across seeds for the intervals")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--center-full-obs", action="store_true",
                   help="evaluate with the Full-obs centering training aid")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    pin_float32()
    device = torch.device(args.device)
    trackers = dict(t.split("=", 1) for t in args.tracker)
    targets = dict(t.split("=", 1) for t in args.target)
    ncfg = NetConfig.from_name(args.network)
    results: dict = {}

    def env_cfg(env_id):
        ecfg = parse_env_id(env_id)
        if args.center_full_obs:
            ecfg = dataclasses.replace(ecfg, center_full_obs=True)
        return ecfg

    def run_cell(env_id, model, evaluator, tracker_name, tracker_path,
                 target_path=None):
        model.reset_parameters(noise.generator(args.seed, device))
        load_params(model, None, tracker_path, target_path)
        rets, lens, succs, per_seed = [], [], [], []
        for s in range(args.eval_seeds):
            ev = evaluator(noise.generator(args.seed + 101 * s, device))
            rets.append(ev["ep_returns"][:, 0])
            lens.append(ev["ep_lens"])
            succs.append(ev["ep_success"])
            per_seed.append({"R_mean": round(float(ev["R_mean"][0]), 2),
                             "S_rate": round(float(ev["S_rate"]), 3)})
        rets = np.concatenate(rets)
        lens = np.concatenate(lens)
        n = len(rets)
        succ = int(np.concatenate(succs).sum())
        row = {"R_mean": round(float(rets.mean()), 2),
               "R_std": round(float(rets.std()), 2),
               "R_ci95": round(1.96 * float(rets.std()) / np.sqrt(n), 2),
               "EL_mean": round(float(lens.mean()), 1),
               "EL_std": round(float(lens.std()), 1),
               "S_rate": round(succ / n, 4),
               "S_ci95": wilson_ci(succ, n),
               "episodes": n,
               "eval_seeds": args.eval_seeds,
               "per_seed": per_seed,
               "ep_returns": [round(float(r), 2) for r in rets],
               "ep_lens": [int(x) for x in lens]}
        key = tracker_name if target_path is None else f"{tracker_name}+target"
        results.setdefault(env_id, {})[key] = row
        print(env_id, key, json.dumps(
            {k: v for k, v in row.items()
             if k not in ("ep_returns", "ep_lens")}), flush=True)

    def cells(env_id):
        ecfg = env_cfg(env_id)
        model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                            device=device)
        return model, make_evaluator(model, TrackEnv(ecfg, device), ncfg,
                                     args.num_episodes)

    for env_id in args.env or PAPER_ENVS:
        model, evaluator = cells(env_id)
        for name, path in trackers.items():
            run_cell(env_id, model, evaluator, name, path)

    if targets:
        model, evaluator = cells(args.adv_env)
        for tname, tpath in trackers.items():
            for gpath in targets.values():
                run_cell(args.adv_env, model, evaluator, tname, tpath, gpath)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
