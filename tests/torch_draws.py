"""The random draws of the JAX package's reset, made from its own keys.

The PyTorch port takes its randomness as tensors at a seam. These helpers
split a ``jax.random`` key exactly as ``active_tracking_rl_tpu/envs/env.py:reset``
and the functions under it do, make the same ``jax.random`` draws, and hand
them to the port, so both packages compute from identical randomness.

Importing this module also pins PyTorch to one CPU thread: the port's tests
run many small ops, which PyTorch's intra-op thread pool slows down by two
orders of magnitude on a shared CPU (and pytest-xdist already runs one
worker per core).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from active_tracking_rl_tpu.envs.maps import maze_loop_bounds
from active_tracking_rl_tpu.envs.types import EnvState as JaxEnvState
from active_tracking_rl_torch.config import EnvConfig as TorchEnvConfig
from active_tracking_rl_torch.envs.env import ResetDraws
from active_tracking_rl_torch.envs.maps import MapDraws, SpawnDraws
from active_tracking_rl_torch.envs.opponents import NavDraws, RamDraws
from active_tracking_rl_torch.envs.types import EnvState
from active_tracking_rl_torch.rl.learner import StepNoise

torch.set_num_threads(1)


def torch_cfg(jax_cfg) -> TorchEnvConfig:
    """The port's EnvConfig with the same field values."""
    fields = {f: getattr(jax_cfg, f)
              for f in TorchEnvConfig.__dataclass_fields__}
    return TorchEnvConfig(**fields)


def _map_draws(cfg, key):
    """generate_map(cfg, key): the Block permutation or the Maze walk's draws.

    The walk's step draw is randint(k, (), 0, m) with m the number of valid
    neighbours; it is made here for each m in 2, 3, 4 from the same key.
    """
    k_ratio, k_rest = jax.random.split(key)
    u = jax.random.uniform(k_ratio)
    if cfg.map_type != "Maze":
        return dict(ratio_u=u, perm=jax.random.permutation(
            k_rest, (cfg.maze_size - 2) ** 2))
    max_complexity, max_density = maze_loop_bounds(cfg)
    half = cfg.maze_size // 2
    outer = jax.random.split(k_rest, 2 * max_density).reshape(
        max_density, 2, -1)

    def start(k_xy):
        kx, ky = jax.random.split(k_xy)
        return jnp.stack([jax.random.randint(ky, (), 0, half + 1),
                          jax.random.randint(kx, (), 0, half + 1)])

    def picks(k_inner):
        ks = jax.random.split(k_inner, max_complexity)
        return jnp.stack([jax.vmap(lambda k: jax.random.randint(k, (), 0, m))(ks)
                          for m in (2, 3, 4)], axis=-1)

    return dict(ratio_u=u, walk_start=jax.vmap(start)(outer[:, 0]),
                walk_pick=jax.vmap(picks)(outer[:, 1]))


def _map(d) -> MapDraws:
    return MapDraws(d["ratio_u"], *(d[k].long() if k in d else None
                                    for k in ("perm", "walk_start",
                                              "walk_pick")))


def _spawn_draws(cfg, key):
    """sample_spawns(cfg, key, maze)."""
    cells = cfg.maze_size ** 2
    k_goal, k_trk, k_tgt, k_retry = jax.random.split(key, 4)
    return dict(
        tracker=jax.random.gumbel(k_trk, (cells,)),
        goals=jax.random.gumbel(k_goal, (cells,)),
        retry=jnp.stack([jax.random.gumbel(jax.random.fold_in(k_retry, i),
                                           (cells,)) for i in range(8)]),
        target=jax.random.gumbel(k_tgt, (cells,)))


def _nav_draws(cfg, key):
    """nav_tape(cfg, key, ...): candidates from k_cand (Nav), planB from
    k_scan."""
    cells = cfg.maze_size ** 2
    k_cand, k_scan = jax.random.split(key)
    d = dict(planb=jax.vmap(lambda k: jax.random.randint(
        k, (), 0, cfg.num_actions, jnp.int8))(
            jax.random.split(k_scan, cfg.tape_len)))
    if cfg.target_mode == "Nav":
        d["candidates"] = jax.vmap(lambda k: jax.random.gumbel(k, (cells,)))(
            jax.random.split(k_cand, cfg.nav_goal_candidates - 1))
    return d


def _ram_draws(cfg, key):
    """ram_tape(cfg, key): the first burst, then four draws per tick."""
    na = cfg.num_actions
    k_init, k_scan = jax.random.split(key)
    ki1, ki2 = jax.random.split(k_init)

    def tick(k):
        kc, ka, kn, kp = jax.random.split(k, 4)
        return (jax.random.randint(kc, (), 0, 2),
                jax.random.randint(ka, (), 0, na, jnp.int8),
                jax.random.randint(kn, (), 1, 10, jnp.int32),
                jax.random.randint(kp, (9,), 0, na, jnp.int8))

    coin, burst, length, plan = jax.vmap(tick)(
        jax.random.split(k_scan, cfg.tape_len))
    return dict(plan0=jax.random.randint(ki1, (9,), 0, na, jnp.int8),
                len0=jax.random.randint(ki2, (), 1, 10, jnp.int32),
                coin=coin, burst=burst, length=length, plan=plan)


def _tape_draws(cfg, key):
    if cfg.target_mode in ("Nav", "RPF"):
        return _nav_draws(cfg, key)
    if cfg.target_mode == "Ram":
        return _ram_draws(cfg, key)
    return {}


def _reset_draws(cfg, key):
    """reset(cfg, key): map, spawns and tape keys split three ways."""
    k_map, k_spawn, k_tape = jax.random.split(key, 3)
    return {**_map_draws(cfg, k_map), **_spawn_draws(cfg, k_spawn),
            **_tape_draws(cfg, k_tape)}


@functools.lru_cache(maxsize=None)
def _batched(fn, cfg):
    return jax.jit(jax.vmap(functools.partial(fn, cfg)))


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def map_draws(jax_cfg, keys) -> MapDraws:
    return _map(_torch(_batched(_map_draws, jax_cfg)(keys)))


def spawn_draws(jax_cfg, keys) -> SpawnDraws:
    d = _torch(_batched(_spawn_draws, jax_cfg)(keys))
    return SpawnDraws(d["tracker"], d["goals"], d["retry"], d["target"])


def _nav(d) -> NavDraws:
    return NavDraws(d.get("candidates"), d["planb"])


def _ram(d) -> RamDraws:
    return RamDraws(*(d[f] for f in RamDraws.__dataclass_fields__))


def nav_draws(jax_cfg, keys) -> NavDraws:
    return _nav(_torch(_batched(_nav_draws, jax_cfg)(keys)))


def ram_draws(jax_cfg, keys) -> RamDraws:
    return _ram(_torch(_batched(_ram_draws, jax_cfg)(keys)))


def reset_draws(jax_cfg, keys) -> ResetDraws:
    """The draws `reset(cfg, key)` makes for each key of `keys` (n, 2)."""
    d = _torch(_batched(_reset_draws, jax_cfg)(keys))
    mode = jax_cfg.target_mode
    return ResetDraws(
        _map(d), SpawnDraws(d["tracker"], d["goals"], d["retry"], d["target"]),
        nav=_nav(d) if mode in ("Nav", "RPF") else None,
        ram=_ram(d) if mode == "Ram" else None)


def batch_draws(jax_cfg, key, n: int) -> ResetDraws:
    """The draws of `TrackEnv.reset_batch(key, n)`."""
    return reset_draws(jax_cfg, jax.random.split(key, n))


def torch_state(state: JaxEnvState) -> EnvState:
    """A batched JAX EnvState as the port's EnvState (CPU tensors)."""
    return EnvState(**{f: torch.from_numpy(np.array(getattr(state, f)))
                       for f in EnvState.__dataclass_fields__})


def assert_state_equal(got: EnvState, want: JaxEnvState) -> None:
    for f in EnvState.__dataclass_fields__:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)


def step_noise(carry_key, num_steps: int, num_envs: int,
               num_actions: int, dtype=jnp.float32) -> StepNoise:
    """The Gumbel noise a JAX train step draws from its carry key: per step
    each player's sampling noise (rl/rollout.py run_rollout,
    models/dueling.py step_both), then the tracker's at s_T
    (rl/learner.py loss_fn); float32, as the float32 program draws it
    (also under jax_enable_x64)."""
    _, k_scan, k_next = jax.random.split(carry_key, 3)
    acts = []
    for key_t in jax.random.split(k_scan, num_steps):
        km, _ = jax.random.split(key_t)
        acts.append(np.stack([np.asarray(jax.random.gumbel(
            k, (num_envs, num_actions), dtype)) for k in jax.random.split(km)],
            axis=1))
    boot = jax.random.gumbel(jax.random.fold_in(k_next, 7),
                             (num_envs, num_actions), dtype)
    return StepNoise(torch.from_numpy(np.stack(acts)),
                     torch.from_numpy(np.array(boot)))


def capture_grads(inner: optax.GradientTransformation
                  ) -> optax.GradientTransformation:
    """The same transformation, which also hands back the raw gradients in
    its state, so a jitted JAX train step exposes them."""
    def init(params):
        return inner.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                          params)

    def update(grads, state, params=None):
        updates, s = inner.update(grads, state[0], params)
        return updates, (s, grads)

    return optax.GradientTransformation(init, update)
