"""The random agent: the env alone, no model and no learner.

Port of ``active_tracking_rl_tpu/run/random_agent.py``. Two modes:
  * default: `--num-envs` envs reset at once (``reset_batch_chunked``; on a
    Nav id that floods every row's 16 goal fields in one launch on the
    card), then 20-step blocks of uniformly random actions for `--seconds`;
    prints the env-steps/s;
  * --episodes K: K episodes one after another, printing each one's length
    and rewards; with `--gif out.gif` the first is rendered to a GIF (needs
    PIL).

Usage:
    python -m active_tracking_rl_torch.run.random_agent -e Track2D-BlockPartialNav-v0
    python -m active_tracking_rl_torch.run.random_agent --episodes 3 --gif /tmp/ep.gif
    python -m active_tracking_rl_torch.run.random_agent --device cpu --num-envs 64 --seconds 1
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from active_tracking_rl_torch.config import parse_env_id
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.envs.render import render_state, save_episode_gif
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.utils.platform import (pin_deterministic,
                                                     pin_float32)

#: env steps per timed block
BLOCK_STEPS = 20


def build_argparser() -> argparse.ArgumentParser:
    """The JAX script's flags, plus --device."""
    p = argparse.ArgumentParser(description="random-agent env runner")
    p.add_argument("-e", "--env_id", default="Track2D-BlockPartialNav-v0")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--episodes", type=int, default=0)
    p.add_argument("--gif", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for small runs)")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_episodes(env: TrackEnv, episodes: int, seed: int,
                 gif: Optional[str] = None) -> list:
    """`episodes` random episodes; returns [(length, rewards (agents,))]."""
    cfg = env.cfg
    gen = noise.generator(seed, env.device)
    rng = np.random.default_rng(seed)
    frames, out = [], []
    for ep in range(episodes):
        state, _ = env.reset_batch(1, gen)
        total = np.zeros(cfg.num_agents)
        done, t = False, 0
        while not done:
            a = rng.integers(0, cfg.num_actions, size=(1, cfg.num_agents))
            state, _, rew, done_t, _ = env.step(
                state, torch.from_numpy(a.astype(np.int32)).to(env.device))
            total += rew[0].cpu().numpy()
            done = bool(done_t[0])
            if gif and ep == 0:
                frames.append(render_state(cfg, state, mode="rgb_array"))
            t += 1
        print(f"episode {ep}: len {t} rewards {total.round(2)}")
        out.append((t, total))
    if frames:
        save_episode_gif(frames, gif)
        print(f"wrote {len(frames)} frames -> {gif}")
    return out


def run_fps(env: TrackEnv, n: int, seconds: float, seed: int) -> dict:
    """n envs reset at once, then BLOCK_STEPS-step blocks of random actions
    for `seconds` (after one warm-up block); returns the env-steps/s, the
    blocks and the seconds."""
    cfg = env.cfg
    gen = noise.generator(seed, env.device)
    state, _ = env.reset_batch_chunked(n, gen)

    def run_block(state):
        for _ in range(BLOCK_STEPS):
            acts = noise.randint(cfg.num_actions, (n, cfg.num_agents), gen,
                                 env.device, torch.int32)
            state, _, _, _, _ = env.step(state, acts)
        return state

    state = run_block(state)   # warm-up
    _sync(env.device)
    t0, blocks = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        state = run_block(state)
        blocks += 1
    _sync(env.device)
    dt = time.perf_counter() - t0
    return dict(fps=blocks * n * BLOCK_STEPS / dt, blocks=blocks, seconds=dt)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    pin_float32()
    pin_deterministic()
    env = TrackEnv(parse_env_id(args.env_id), args.device)
    if args.episodes:
        return run_episodes(env, args.episodes, args.seed, args.gif)
    out = run_fps(env, args.num_envs, args.seconds, args.seed)
    print(f"{args.env_id}: {out['fps']:,.0f} env-steps/s ({args.num_envs} "
          f"envs x {BLOCK_STEPS}-step blocks, {env.device})")
    return out


if __name__ == "__main__":
    main()
