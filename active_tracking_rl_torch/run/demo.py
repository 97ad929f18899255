"""Render a trained agent: greedy episodes through the gym bridge, to a GIF.

Port of ``active_tracking_rl_tpu/run/demo.py`` (the reference's
``gym_eval.py --render`` workflow). The JAX script's flags, plus
`--device`. Each episode resets a ``GymTrackEnv`` (a new map, spawns and
tape; on a Nav id one ``flood_sweep`` launch on the card), then both
players act greedily (``step_both(test=True)``) until the episode ends;
every state is rendered, so an episode of length L gives L + 1 frames.
:func:`run_episode` is the loop, and takes given reset draws.

    python -m active_tracking_rl_torch.run.demo \\
        --env Track2D-BlockPartialNav-v0 --load-tracker .../tracker-best.msgpack \\
        --load-target .../target-best.msgpack --gif demo.gif

The GIF needs PIL (pillow), which the port does not depend on: without it
`--gif` raises before any episode runs; `--gif ''` writes none.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from active_tracking_rl_torch.config import NetConfig, parse_env_id
from active_tracking_rl_torch.envs.bridge import GymTrackEnv
from active_tracking_rl_torch.envs.env import ResetDraws
from active_tracking_rl_torch.envs.render import save_episode_gif
from active_tracking_rl_torch.models.dueling import DuelingModel, build_model
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.rl.checkpoint import load_params
from active_tracking_rl_torch.utils.platform import (pin_float32,
                                                     resolve_device)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="greedy episodes to a GIF")
    p.add_argument("--env", default="Track2D-BlockPartialNav-v0")
    p.add_argument("--network", default="tat-maze-lstm")
    p.add_argument("--load-tracker", default=None)
    p.add_argument("--load-target", default=None)
    p.add_argument("--load-model-dir", default=None)
    p.add_argument("--episodes", type=int, default=1)
    p.add_argument("--gif", default="demo.gif",
                   help="the GIF to write (needs PIL); '' for none")
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--rnn-out", type=int, default=128)
    p.add_argument("--center-full-obs", action="store_true",
                   help="feed the policy egocentrically centered Full-obs "
                        "frames (must match how the checkpoint was trained); "
                        "rendering still shows the true map")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for small runs)")
    return p


@torch.no_grad()
def run_episode(model: DuelingModel, env: GymTrackEnv, net_cfg: NetConfig,
                draws: Optional[ResetDraws] = None
                ) -> Tuple[List[np.ndarray], int, float]:
    """One greedy episode from `draws` (one row; None draws from the env's
    generator) -> (rgb frames, its length, the tracker's return)."""
    device = next(model.parameters()).device
    obs = env.reset(draws)
    hx = torch.zeros((1, 2, net_cfg.rnn_out), dtype=torch.float32,
                     device=device)
    cx = torch.zeros_like(hx)
    done, t, ret = False, 0, 0.0
    frames = [env.render(mode="rgb_array")]
    while not done:
        # (2, 1, H, W) channel-first -> (1, 2, k=1, H, W, 1)
        o = torch.as_tensor(obs, device=device)[None, ..., None]
        _, actions, _, _, hx, cx, _ = model.step_both(o, hx, cx, None,
                                                      test=True)
        obs, rew, done, _ = env.step(actions[0].cpu().numpy())
        ret += float(rew[0])
        frames.append(env.render(mode="rgb_array"))
        t += 1
    return frames, t, ret


def main(argv=None) -> List[Tuple[List[np.ndarray], int, float]]:
    """Runs the episodes; returns each one's (frames, length, return)."""
    args = build_argparser().parse_args(argv)
    pin_float32()
    if args.gif:
        try:
            import PIL  # noqa: F401
        except ImportError as e:
            raise ImportError(f"--gif {args.gif}: writing a GIF needs PIL "
                              f"(pillow), which is not installed; pass "
                              f"--gif '' to run without one") from e
    device = resolve_device(args.device)
    ecfg = parse_env_id(args.env)
    if args.center_full_obs:
        ecfg = dataclasses.replace(ecfg, center_full_obs=True)
    ncfg = NetConfig.from_name(args.network, rnn_out=args.rnn_out)
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, device=device,
                        generator=noise.generator(0, device))
    load_params(model, args.load_model_dir, args.load_tracker,
                args.load_target)

    env = GymTrackEnv(args.env, cfg=ecfg, seed=args.seed, device=device)
    episodes, frames = [], []
    for ep in range(args.episodes):
        ep_frames, t, ret = run_episode(model, env, ncfg)
        episodes.append((ep_frames, t, ret))
        frames += ep_frames
        print(f"episode {ep}: len {t} tracker return {ret:.1f}")
    if args.gif:
        save_episode_gif(frames, args.gif)
        print(f"wrote {len(frames)} frames -> {args.gif}")
    return episodes


if __name__ == "__main__":
    main()
