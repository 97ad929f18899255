"""Where does one learner iteration go? Seconds per call of its parts on
one card.

Port of the repository's root ``profile_iter.py``, with its keys:

* for Block Nav and Block Ram (``BlockPartialNav``, ``BlockPartialRam``) at
  4096 envs and a pool of 512: the full train step (``train_step_s``: pool,
  rollout, loss, backward, update; remat off, TrainConfig's default as in
  the JAX script), the reset pool alone (``pool_s``), map generation alone
  (``maps_s``) and ``steps_per_s``; the port adds the pool's parts on one
  set of draws (``pool_map_s``, ``pool_spawns_s``, ``pool_tape_s``: the
  scripted tape with its floods);
* ``core_decomposition_k16``: the step on an external pool
  (``core_step_s``, remat on as in the JAX script), the rollout under
  ``torch.no_grad()`` (``rollout_fwd_s``), their difference (``backward_s``: loss, backward and update), the model's
  joint forward over T steps on one frame (``model_scan_s``), the env's
  T steps with random actions (``env_scan_s``) and T autoresets with done
  drawn at p 0.04 (``autoreset_scan_s``);
* ``nav_tape_s``: the Nav tapes of 512 rows (``envs/opponents.py:nav_tape``,
  its 16 floods included);
* ``flood_xla_s`` and ``flood_pallas_s``: 512 x 16 fields through
  ``distance_fields_backend``'s "xla" (the plain relaxation) and "pallas"
  (the ``flood_relax`` kernel) backends.

Each part runs 2 untimed calls, then 5 timed ones between two
``torch.cuda.synchronize()`` calls, as the JAX script's ``timeit``; randomness comes from
``noise.Threefry``s seeded as the JAX script's keys. Prints one JSON dict.

    python -m active_tracking_rl_torch.run.profile_iter
    python -m active_tracking_rl_torch.run.profile_iter --device cpu \\
        --num-envs 16 --pool 8
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict

import torch

from active_tracking_rl_torch.config import (NetConfig, TrainConfig,
                                             parse_env_id)
from active_tracking_rl_torch.envs import maps
from active_tracking_rl_torch.envs.distance import distance_fields_backend
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.envs.opponents import (build_tape, draw_nav,
                                                     nav_tape)
from active_tracking_rl_torch.models.dueling import build_model
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.rl.learner import (init_learner, init_pool_ptr,
                                                 make_pool_fn, make_train_step)
from active_tracking_rl_torch.rl.rollout import (draw_action_noise,
                                                 obs_to_model, run_rollout)
from active_tracking_rl_torch.utils.platform import (pin_float32,
                                                     resolve_device, sync)

NUM_ENVS = 4096
POOL = NUM_ENVS // 8
ENVS = ("Track2D-BlockPartialNav-v0", "Track2D-BlockPartialRam-v0")


def _gen(device: torch.device, seed: int) -> noise.Threefry:
    return noise.generator(seed, device)


def timeit(fn: Callable, device: torch.device, iters: int = 5,
           warmup: int = 2) -> float:
    """Seconds per call of fn(): `warmup` untimed calls, then `iters` timed
    ones, the card synchronized at both edges of the window."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters


def pool_parts(env: TrackEnv, rows: int, generator: noise.Threefry,
               iters: int = 5, warmup: int = 2) -> Dict[str, float]:
    """Seconds per call of the reset pool's parts, in reset's order, on one
    set of draws of `rows` rows: the map, the spawns, the scripted tape
    (its floods included)."""
    cfg, dev = env.cfg, env.device
    draws = env.draw_reset(rows, generator)
    maze = maps.generate_map(cfg, draws.map)
    pos, goals = maps.sample_spawns(cfg, maze, draws.spawns)
    return {
        "pool_map_s": timeit(lambda: maps.generate_map(cfg, draws.map), dev,
                             iters, warmup),
        "pool_spawns_s": timeit(lambda: maps.sample_spawns(
            cfg, maze, draws.spawns), dev, iters, warmup),
        "pool_tape_s": timeit(lambda: build_tape(
            cfg, maze, pos[:, 1], goals[:, 1], draws.nav, draws.ram), dev,
            iters, warmup),
    }


def _learner(env_id: str, num_envs: int, pool: int, device, remat: bool):
    ecfg = parse_env_id(env_id)
    env = TrackEnv(ecfg, device)
    tcfg = TrainConfig(env_id=env_id, num_envs=num_envs, reset_pool=pool,
                       train_mode=0, remat=remat)
    ncfg = NetConfig.from_name("maze-lstm", aux="none")
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                        device=device)
    state = init_learner(model, env, ncfg, tcfg, _gen(device, 0))
    return env, tcfg, model, state


def profile_env(env_id: str, num_envs: int, pool: int, device,
                iters: int = 5, warmup: int = 2) -> Dict[str, float]:
    """The train step, the pool, the maps and the pool's parts of
    `env_id`."""
    env, tcfg, model, state = _learner(env_id, num_envs, pool, device,
                                       remat=False)
    step = make_train_step(model, env, model.cfg, tcfg, state.opt)
    t_step = timeit(lambda: step(state.carry, 0), device, iters, warmup)
    gen = _gen(device, 1)
    t_pool = timeit(lambda: env.reset_batch(pool, gen), device, iters,
                    warmup)
    gen = _gen(device, 2)
    t_maps = timeit(lambda: maps.generate_map(
        env.cfg, maps.draw_map(env.cfg, pool, gen, device)), device, iters,
        warmup)
    return {"train_step_s": t_step, "pool_s": t_pool, "maps_s": t_maps,
            "steps_per_s": num_envs * tcfg.num_steps / t_step,
            **pool_parts(env, pool, _gen(device, 6), iters, warmup)}


def core_decomposition(num_envs: int, pool: int, device, iters: int = 5,
                       warmup: int = 2) -> Dict[str, float]:
    """The iteration on an external pool, split into its parts (the JAX
    script's K=16 core decomposition), remat on."""
    env, tcfg, model, state = _learner("Track2D-BlockPartialNav-v0",
                                       num_envs, pool, device, remat=True)
    ext = (*make_pool_fn(env, tcfg)(_gen(device, 9)),
           init_pool_ptr(device=device))
    step = make_train_step(model, env, model.cfg, tcfg, state.opt)
    carry = state.carry
    core = {"core_step_s": timeit(lambda: step(carry, 0, ext), device,
                                  iters, warmup)}

    def rollout_fwd():
        with torch.no_grad():
            return run_rollout(model, env, tcfg, carry, ext[:2])

    core["rollout_fwd_s"] = timeit(rollout_fwd, device, iters, warmup)
    core["backward_s"] = core["core_step_s"] - core["rollout_fwd_s"]

    t_steps, n = tcfg.num_steps, carry.obs_stack.shape[0]
    gen = _gen(device, 1)

    @torch.no_grad()
    def model_scan():
        obs_f = obs_to_model(carry.obs_stack)
        nz = draw_action_noise(t_steps, n, env.num_actions, gen, device)
        hx, cx = carry.hx, carry.cx
        for t in range(t_steps):
            out = model.step_both(obs_f, hx, cx, nz[t])
            hx, cx = out[4], out[5]
        return hx

    core["model_scan_s"] = timeit(model_scan, device, iters, warmup)
    gen_env = _gen(device, 2)

    def env_scan():
        s = carry.env_state
        for _ in range(t_steps):
            a = noise.randint(4, (n, 2), gen_env, device)
            s, _, rew, _, _ = env.step(s, a)
        return rew

    core["env_scan_s"] = timeit(env_scan, device, iters, warmup)
    gen_done = _gen(device, 3)
    obs0 = carry.obs_stack[:, :, 0]

    def autoreset_scan():
        s, ptr = carry.env_state, init_pool_ptr(device=device)
        for _ in range(t_steps):
            done = noise.uniform((n,), gen_done, device) < 0.04
            s, o, ptr = env.autoreset(s, obs0, done, ext[0], ext[1], ptr)
        return o

    core["autoreset_scan_s"] = timeit(autoreset_scan, device, iters, warmup)
    return core


def profile_floods(pool: int, device, iters: int = 5,
                   warmup: int = 2) -> Dict[str, float]:
    """The Nav tapes of `pool` rows, then `pool` x 16 fields through the
    "xla" and "pallas" backends, on Block Nav maps."""
    ecfg = parse_env_id("Track2D-BlockPartialNav-v0")
    mz = maps.generate_map(ecfg, maps.draw_map(ecfg, pool, _gen(device, 3),
                                               device))
    goals = torch.full((pool, 16, 2), 40, dtype=torch.int32, device=device)
    spawn = torch.full((pool, 2), 41, dtype=torch.int32, device=device)
    gen = _gen(device, 5)
    out = {"nav_tape_s": timeit(lambda: nav_tape(
        ecfg, mz, spawn, spawn, draw_nav(ecfg, pool, gen, device)), device,
        iters, warmup)}
    for backend in ("xla", "pallas"):
        out[f"flood_{backend}_s"] = timeit(
            lambda b=backend: distance_fields_backend(mz, goals,
                                                      ecfg.flood_iters, b),
            device, iters, warmup)
    return out


def profile_iter(num_envs: int = NUM_ENVS, pool: int = POOL, device="cuda",
                 iters: int = 5, warmup: int = 2) -> Dict:
    """Every part, by the JAX script's keys."""
    dev = resolve_device(device)
    results: Dict = {}
    for env_id in ENVS:
        results[env_id.split("-")[1]] = profile_env(env_id, num_envs, pool,
                                                    dev, iters, warmup)
    results["core_decomposition_k16"] = core_decomposition(
        num_envs, pool, dev, iters, warmup)
    results.update(profile_floods(pool, dev, iters, warmup))
    return results


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="seconds per call of the parts "
                                "of one learner iteration")
    p.add_argument("--num-envs", type=int, default=NUM_ENVS)
    p.add_argument("--pool", type=int, default=None,
                   help="reset pool rows (default num-envs // 8)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for small runs)")
    return p


def main(argv=None) -> Dict:
    args = build_argparser().parse_args(argv)
    pin_float32()
    out = profile_iter(args.num_envs, args.pool or args.num_envs // 8,
                       args.device)
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
