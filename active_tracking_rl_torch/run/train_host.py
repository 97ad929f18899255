"""Host-env training CLI: the reference's 3D recipe, on the port's model.

Port of ``active_tracking_rl_tpu/run/train_host.py``. Builds a
``HostEnvPool`` of `--num-envs` ``create_env`` instances (the wrapper chain:
Rescale, ImagePreprocess, FrameStack) and trains through
``rl/host_loop.py``: act and update on `--device`, the envs stepped on the
host. Works with any gym-API env, gym_unrealcv's where it is installed; a
Track2D id runs the built-in gym adapter, whose envs live on `--device` too
(on a Nav id every reset floods its navigator's goal fields there). The
flags are the JAX CLI's, plus `--device`. Every 10 iterations (and the
first) it logs a line and writes a ``metrics.jsonl`` row; every
`--checkpoint-every` iterations and at the last it writes flax-format
parameter files (``all-*``, ``tracker-*`` and, with two players,
``target-*``) and ``train_state.pt``.

On the card:

    python -m active_tracking_rl_torch.run.train_host \\
        --env Track2D-BlockPartialNav-v0 --num-envs 16 --total-iters 200

A tiny run on the CPU:

    python -m active_tracking_rl_torch.run.train_host --device cpu \\
        --env Track2D-BlockPartialRam-v0 --num-envs 2 --num-steps 4 \\
        --total-iters 2 --checkpoint-every 2 --log-dir /tmp/logs
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from active_tracking_rl_torch.config import (NetConfig, TrainConfig,
                                             parse_env_id)
from active_tracking_rl_torch.envs.bridge import HostEnvPool, create_env
from active_tracking_rl_torch.models.dueling import (build_model,
                                                     params_to_flax)
from active_tracking_rl_torch.rl.checkpoint import CheckpointManager
from active_tracking_rl_torch.rl.host_loop import HostTrainer
from active_tracking_rl_torch.run.train import metrics_to_host
from active_tracking_rl_torch.utils.logging import (MetricWriter, close_logger,
                                                    setup_logger)
from active_tracking_rl_torch.utils.platform import (pin_deterministic,
                                                     pin_float32)


def build_argparser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, names and defaults, plus --device."""
    p = argparse.ArgumentParser(description="host-env (3D family) trainer")
    p.add_argument("--env", default="Track2D-BlockPartialRam-v0")
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--tau", type=float, default=1.0)
    p.add_argument("--entropy", type=float, default=0.01)
    p.add_argument("--entropy-target", type=float, default=0.2)
    p.add_argument("--network", default="maze-lstm")
    p.add_argument("--aux", default="none")
    p.add_argument("--train-mode", type=int, default=0)
    p.add_argument("--optimizer", default="Adam")
    p.add_argument("--stack-frames", type=int, default=1)
    p.add_argument("--rnn-out", type=int, default=128)
    p.add_argument("--rescale", action="store_true",
                   help="the Rescale wrapper (3D family)")
    p.add_argument("--input-size", type=int, default=80)
    p.add_argument("--gray", action="store_true")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--total-iters", type=int, default=1000)
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and of Track2D envs "
                        "(default cuda; cpu for small runs)")
    return p


@dataclasses.dataclass
class HostRun:
    """What `main` ran: the trainer at its end, its run directory and the
    last logged metrics (host numbers)."""

    trainer: HostTrainer
    run_dir: str
    last_metrics: Optional[Dict[str, np.ndarray]] = None


def main(argv=None) -> HostRun:
    args = build_argparser().parse_args(argv)
    pin_float32()
    pin_deterministic()
    tcfg = TrainConfig(
        env_id=args.env, lr=args.lr, gamma=args.gamma, tau=args.tau,
        entropy=args.entropy, entropy_target=args.entropy_target,
        seed=args.seed, num_steps=args.num_steps, num_envs=args.num_envs,
        optimizer=args.optimizer, train_mode=args.train_mode)
    ncfg = NetConfig.from_name(args.network, rnn_out=args.rnn_out,
                               stack_frames=args.stack_frames, aux=args.aux)
    device = torch.device(args.device)

    run_dir = os.path.join(args.log_dir, args.env + "-host",
                           datetime.now().strftime("%b%d_%H-%M"))
    log = setup_logger(f"{args.env}_host_log", os.path.join(run_dir, "logger"))
    try:
        for k, v in vars(args).items():
            log.info(f"{k}: {v}")
        return _train(args, tcfg, ncfg, device, run_dir, log)
    finally:
        close_logger(log)


def _train(args, tcfg: TrainConfig, ncfg: NetConfig, device: torch.device,
           run_dir: str, log) -> HostRun:
    pool = HostEnvPool([
        (lambda i=i: create_env(args.env, rescale=args.rescale,
                                stack_frames=args.stack_frames,
                                input_size=args.input_size, gray=args.gray,
                                seed=args.seed + i, device=device))
        for i in range(args.num_envs)])
    probe = pool.envs[0]
    action_low = action_high = None
    if "Track2D" in args.env:
        ecfg = parse_env_id(args.env)
        num_actions, obs_hw = ecfg.num_actions, ecfg.obs_shape
        single = False            # 1v1: a scripted or learned second agent
    else:
        space = probe.action_space
        num_actions = getattr(space, "n", None) or space.shape[-1]
        obs_hw = tuple(probe.observation_space.shape[-2:])
        single = True             # an external single-agent env
        if ncfg.continuous and hasattr(space, "low"):
            # the Box bounds that wrap_action rescales [-1, 1] actions to
            action_low = np.asarray(space.low, np.float32)
            action_high = np.asarray(space.high, np.float32)

    model = build_model(ncfg, num_actions, obs_hw, device=device,
                        single=single)
    trainer = HostTrainer(model, ncfg, tcfg, pool, seed=args.seed,
                          action_low=action_low, action_high=action_high)
    run = HostRun(trainer, run_dir)
    writer = MetricWriter(run_dir)
    ckpt = CheckpointManager(run_dir, split=True)

    env_steps_per_iter = args.num_envs * args.num_steps
    t_last = time.time()
    try:
        for it in range(1, args.total_iters + 1):
            m = trainer.train_iter(mode=args.train_mode)
            if it % 10 == 0 or it == 1:
                h = run.last_metrics = metrics_to_host(m)
                fin = trainer.finished_returns[-50:]
                r0 = np.mean(fin) if fin else 0.0
                fps = (10 if it > 1 else 1) * env_steps_per_iter / (
                    time.time() - t_last)
                t_last = time.time()
                writer.write(it, {
                    "train/policy_loss_0": h["policy_loss"][0],
                    "train/value_loss_0": h["value_loss"][0],
                    "train/entropies0": h["entropy"][0],
                    "train/reward_0": r0,
                    "train/fps": fps,
                    "train/grad_norm": h["grad_norm"],
                })
                log.info(f"iter {it} loss {float(h['loss']):.3f} "
                         f"R0 {r0:.1f} env-steps/s {fps:.0f}")
            if it % args.checkpoint_every == 0 or it == args.total_iters:
                fin = trainer.finished_returns[-100:]
                score = float(np.mean(fin)) if fin else -1e9
                ckpt.save(params_to_flax(model.state_dict(), ncfg),
                          {"model": model.state_dict(),
                           "optimizer": trainer.opt.state_dict(),
                           "step": it}, score, it)
                log.info(f"checkpoint iter {it}: recent R0 {score:.1f}")
    finally:
        writer.close()
    return run


if __name__ == "__main__":
    main()
