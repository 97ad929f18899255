"""Golden-trajectory parity harness for the port's own engine.

Port of ``active_tracking_rl_tpu/run/parity.py``, in its two tiers:

1. **Self-replay (bit-exact)**: with a fixed seed the engine reproduces a
   recorded random-policy trajectory (maps, spawns, scripted-opponent
   actions, observations, rewards, termination) bit for bit. ``record``
   writes the golden ``.npz``; ``verify`` replays it and diffs every array.
   The reset draws come from a ``noise.Threefry`` on the trace's device
   (:func:`rollout_trace` also takes them at a seam, as the tests do with
   the JAX package's); its draws are the same on the card and the CPU,
   but the card's float arithmetic may differ in the last ulp, so a trace
   replays bit for bit on the device type it was recorded on.
2. **Cross-validation against the reference env (semantic)**: ``cross-check``
   drives the reference package's ``Track1v1Env`` with a deterministic
   global RNG and checks, on every transition, the invariants both engines
   share, with the NumPy oracles of ``tests/oracles.py``: the reward
   formula, the termination counter, the collision dynamics, the target's
   legal moves and the observation painting. It needs the reference
   package (``gym_track2d``): the caller names its checkout (``--reference``,
   the ``envs/gym-track2d`` directory of the reference repository), and
   cross_check raises ImportError where it cannot import it: a check that
   cannot run never reads as a pass.

Usage:
    python -m active_tracking_rl_torch.run.parity record --env Track2D-BlockPartialNav-v0 --out golden.npz
    python -m active_tracking_rl_torch.run.parity verify --golden golden.npz
    python -m active_tracking_rl_torch.run.parity cross-check --env Track2D-BlockPartialNav-v0 \
        --reference <reference repo>/envs/gym-track2d
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import sys
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from active_tracking_rl_torch.config import parse_env_id
from active_tracking_rl_torch.envs.env import ResetDraws, TrackEnv
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.utils.platform import (pin_deterministic,
                                                     pin_float32,
                                                     resolve_device)

#: the repository root (the NumPy oracles, the gym shims)
ROOT = Path(__file__).resolve().parents[2]
TRACE_KEYS = ("obs", "rewards", "done", "pos", "actions", "dist")
#: the longest episode of a trace
MAX_TRACE_STEPS = 80


def rollout_trace(env_id: str, seed: int, episodes: int = 2,
                  policy_seed: int = 0,
                  draws: Optional[Sequence[ResetDraws]] = None,
                  device="cuda") -> dict:
    """A random-policy trace of the engine, as host arrays.

    Each episode resets one row from `draws[ep]` (ResetDraws of one row),
    or, with `draws` None, from a generator seeded with `seed`; the actions
    come from numpy's ``default_rng(policy_seed)``, as in the JAX harness.
    """
    cfg = parse_env_id(env_id)
    env = TrackEnv(cfg, resolve_device(device))
    gen = noise.generator(seed, env.device)
    rng = np.random.default_rng(policy_seed)
    out = {k: [] for k in TRACE_KEYS}
    for ep in range(episodes):
        d = draws[ep] if draws is not None else env.draw_reset(1, gen)
        state, obs = env.reset(d)
        out["obs"].append(obs[0].cpu().numpy())
        out["pos"].append(state.pos[0].cpu().numpy())
        done, t = False, 0
        while not done and t < MAX_TRACE_STEPS:
            a = rng.integers(0, cfg.num_actions, size=(cfg.num_agents,))
            acts = torch.as_tensor(a.astype(np.int32)[None], device=env.device)
            state, obs, rew, done_t, _ = env.step(state, acts)
            done = bool(done_t[0])
            out["actions"].append(a)
            out["obs"].append(obs[0].cpu().numpy())
            out["rewards"].append(rew[0].cpu().numpy())
            out["done"].append(done)
            out["pos"].append(state.pos[0].cpu().numpy())
            out["dist"].append(float(state.dist[0]))
            t += 1
    return {k: np.asarray(v) for k, v in out.items()}


def record(env_id: str, seed: int, out_path: str, episodes: int = 2,
           device="cuda") -> None:
    dev = resolve_device(device)
    trace = rollout_trace(env_id, seed, episodes, device=dev)
    np.savez_compressed(out_path, env_id=env_id, seed=seed,
                        episodes=episodes, device_type=dev.type, **trace)
    print(f"recorded {len(trace['actions'])} steps on {dev.type} -> "
          f"{out_path}")


def verify(golden_path: str, device="cuda") -> bool:
    """Replay the golden trace on `device` and diff every array."""
    g = np.load(golden_path, allow_pickle=False)
    dev = resolve_device(device)
    if str(g["device_type"]) != dev.type:
        raise ValueError(f"{golden_path} was recorded on {g['device_type']}; "
                         f"its reset draws replay only there, not on "
                         f"{dev.type}")
    trace = rollout_trace(str(g["env_id"]), int(g["seed"]),
                          int(g["episodes"]), device=dev)
    ok = True
    for k in TRACE_KEYS:
        if not np.array_equal(g[k], trace[k]):
            print(f"MISMATCH in {k}: golden {g[k].shape} vs replay "
                  f"{trace[k].shape}")
            ok = False
    print("parity: " + ("OK (bit-exact)" if ok else "FAILED"))
    return ok


def _import_reference(reference_dir: Path):
    """The reference gym_track2d, with the repo's gym and skimage shims
    after it on the path (an installed gym, if any, still wins)."""
    if not reference_dir.is_dir():
        raise ImportError(f"the reference env is not at {reference_dir}")
    for p in (str(reference_dir), str(ROOT / "shims")):
        if p not in sys.path:
            sys.path.append(p)
    import matplotlib
    matplotlib.use("Agg")
    import gym
    import gym_track2d  # noqa: F401
    return gym


def _oracles():
    """The NumPy oracles of tests/oracles.py, loaded from their file."""
    spec = importlib.util.spec_from_file_location(
        "track2d_oracles", ROOT / "tests" / "oracles.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cross_check(env_id: str, reference_dir: str, steps: int = 200,
                seed: int = 0, rng_patch: bool = True) -> bool:
    """Semantic invariants checked on the reference env's own rollouts;
    `reference_dir` is the reference's gym-track2d checkout.

    Raises ImportError if the reference cannot be imported.
    """
    gym = _import_reference(Path(reference_dir))
    oracle = _oracles()

    np.random.seed(seed)
    seed_fn = np.random.seed
    if rng_patch:
        np.random.seed = lambda *a, **kw: None  # defeat OS reseeding
    ctx = contextlib.ExitStack()
    ctx.enter_context(warnings.catch_warnings())
    # the reference converts a 1-element array with int() every step
    warnings.filterwarnings(
        "ignore", category=DeprecationWarning,
        message="Conversion of an array with ndim > 0 to a scalar")
    try:
        env = gym.make(env_id)
        obs = env.reset()
        raw = env.unwrapped
        is_partial = raw.obs_type == "Partial"
        ok = True
        c_far = 0
        t_ep = 0
        for t in range(steps):
            pos_before = [tuple(int(x) for x in s) for s in raw.state]
            maze = raw.maze.copy()
            actions = [int(np.random.randint(raw.action_space[0].n))
                       for _ in range(2)]
            obs, rew, done, info = env.step(actions)
            t_ep += 1
            pos_after = [tuple(int(x) for x in s) for s in raw.state]
            exp0, _ = oracle.next_state(maze, pos_before[0], actions[0])
            if tuple(exp0) != pos_after[0]:
                print(f"t={t} tracker transition mismatch: {pos_before[0]} "
                      f"a={actions[0]} -> {pos_after[0]}, oracle {exp0}")
                ok = False
            dr = abs(pos_after[1][0] - pos_before[1][0])
            dc = abs(pos_after[1][1] - pos_before[1][1])
            if not ((dr + dc <= 1) and maze[pos_after[1]] == 0):
                print(f"t={t} illegal target move {pos_before[1]} -> "
                      f"{pos_after[1]}")
                ok = False
            r0, r1, d = oracle.rewards(pos_after[0], pos_after[1], raw.w_p)
            if abs(rew[0] - r0) > 1e-9 or abs(rew[1] - r1) > 1e-9:
                print(f"t={t} reward mismatch: {rew} vs ({r0}, {r1})")
                ok = False
            if abs(info["distance"] - d) > 1e-9:
                print(f"t={t} distance mismatch: {info['distance']} vs {d}")
                ok = False
            c_far = 0 if d <= raw.pob_size else c_far + 1
            want_done = c_far > 10 or t_ep >= 500
            if bool(done) != want_done:
                print(f"t={t} done mismatch: {done} vs {want_done} "
                      f"(c_far={c_far}, t_ep={t_ep})")
                ok = False
            for i in range(2):
                want = (oracle.partial_obs(maze, pos_after, i, raw.pob_size)
                        if is_partial else oracle.full_obs(maze, pos_after, i))
                if not np.array_equal(np.asarray(obs[i][0], np.int64), want):
                    print(f"t={t} obs[{i}] mismatch")
                    ok = False
            if done:
                obs = env.reset()
                raw = env.unwrapped
                c_far = 0
                t_ep = 0
        print(f"cross-check[{env_id}] vs the reference env over {steps} "
              "transitions: " + ("OK" if ok else "FAILED"))
        return ok
    finally:
        np.random.seed = seed_fn
        ctx.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("record")
    pr.add_argument("--env", default="Track2D-BlockPartialNav-v0")
    pr.add_argument("--seed", type=int, default=1)
    pr.add_argument("--episodes", type=int, default=2)
    pr.add_argument("--out", default="golden.npz")
    pv = sub.add_parser("verify")
    pv.add_argument("--golden", default="golden.npz")
    for sp in (pr, pv):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    pc = sub.add_parser("cross-check")
    pc.add_argument("--env", default="Track2D-BlockPartialNav-v0")
    pc.add_argument("--steps", type=int, default=200)
    pc.add_argument("--reference", required=True,
                    help="the reference's gym-track2d checkout (the "
                         "envs/gym-track2d directory of its repository)")
    args = p.parse_args(argv)
    pin_float32()
    pin_deterministic()
    if args.cmd == "record":
        record(args.env, args.seed, args.out, args.episodes, args.device)
    elif args.cmd == "verify":
        sys.exit(0 if verify(args.golden, args.device) else 1)
    else:
        sys.exit(0 if cross_check(args.env, args.reference, args.steps)
                 else 1)


if __name__ == "__main__":
    main()
