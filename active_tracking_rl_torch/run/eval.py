"""Offline evaluation CLI. Port of ``active_tracking_rl_tpu/run/eval.py``.

Greedy evaluation of parameter files in flax's format, written by either
package, on one env: `--num-episodes` episodes of up to 500 steps, all as
rows of one batch on `--device`. Players that no file sets keep the
initial parameters of `--seed`. Logs R_mean, R_std, EL_mean, EL_std,
R_step and S_rate, and appends them to `--csv`.

On the card:

    python -m active_tracking_rl_torch.run.eval \\
        --env Track2D-BlockPartialNav-v0 --network tat-maze-lstm \\
        --load-tracker logs/.../tracker-best.msgpack --csv out.csv

On the CPU, add `--device cpu`.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os

import torch

from active_tracking_rl_torch.config import NetConfig, parse_env_id
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import build_model
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.rl.checkpoint import load_params
from active_tracking_rl_torch.rl.evaluate import evaluate
from active_tracking_rl_torch.utils.logging import close_logger, setup_logger
from active_tracking_rl_torch.utils.platform import pin_float32


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="greedy evaluation (PyTorch)")
    p.add_argument("--env", default="Track2D-BlockPartialNav-v0")
    p.add_argument("--num-episodes", type=int, default=100)
    p.add_argument("--load-model-dir", default=None,
                   help="a full parameter file (all-*.msgpack)")
    p.add_argument("--load-tracker", default=None)
    p.add_argument("--load-target", default=None)
    p.add_argument("--log-dir", default="logs/")
    p.add_argument("--csv", default=None)
    p.add_argument("--network", default="tat-maze-lstm")
    p.add_argument("--stack-frames", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rnn-out", type=int, default=128)
    p.add_argument("--center-full-obs", action="store_true",
                   help="evaluate with the Full-obs centering training aid "
                        "(as the checkpoint was trained)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    return p


def load_model(args, ecfg, device):
    """The network of `args` at `--seed`'s initial parameters, then the
    parameter files that `args` names."""
    ncfg = NetConfig.from_name(args.network, rnn_out=args.rnn_out,
                               stack_frames=args.stack_frames)
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, device=device,
                        generator=noise.generator(args.seed, device))
    load_params(model, args.load_model_dir, args.load_tracker,
                args.load_target)
    return model, ncfg


def main(argv=None):
    args = build_argparser().parse_args(argv)
    pin_float32()
    device = torch.device(args.device)
    log = setup_logger(f"{args.env}_mon_log",
                       os.path.join(args.log_dir, f"{args.env}_mon_log"))
    try:
        for k, v in vars(args).items():
            log.info(f"{k}: {v}")
        ecfg = parse_env_id(args.env)
        if args.center_full_obs:
            ecfg = dataclasses.replace(ecfg, center_full_obs=True)
        model, ncfg = load_model(args, ecfg, device)
        metrics = evaluate(model, TrackEnv(ecfg, device), ncfg,
                           noise.generator(args.seed, device), args.num_episodes)
        log.info(
            "R_mean: {0}, R_std: {1}, EL_mean: {2:.2f}, EL_std {3:.2f}, "
            "R_step: {4}, S_rate: {5}".format(
                metrics["R_mean"], metrics["R_std"],
                float(metrics["EL_mean"]), float(metrics["EL_std"]),
                metrics["R_step"], float(metrics["S_rate"])))
    finally:
        close_logger(log)

    if args.csv:
        header = ["Env", "Seed", "R_mean", "R_std", "EL_mean", "EL_std",
                  "S_rate"]
        row = {"Env": args.env, "Seed": args.seed,
               "R_mean": float(metrics["R_mean"][0]),
               "R_std": float(metrics["R_std"][0]),
               "EL_mean": float(metrics["EL_mean"]),
               "EL_std": float(metrics["EL_std"]),
               "S_rate": float(metrics["S_rate"])}
        exists = os.path.exists(args.csv)
        with open(args.csv, "a" if exists else "w", newline="") as f:
            w = csv.DictWriter(f, header)
            if not exists:
                w.writeheader()
            w.writerow(row)
    return metrics


if __name__ == "__main__":
    main()
