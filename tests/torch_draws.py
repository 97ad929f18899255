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
import torch

from active_tracking_rl_tpu.envs.types import EnvState as JaxEnvState
from active_tracking_rl_torch.config import EnvConfig as TorchEnvConfig
from active_tracking_rl_torch.envs.env import ResetDraws
from active_tracking_rl_torch.envs.maps import MapDraws, SpawnDraws
from active_tracking_rl_torch.envs.opponents import NavDraws
from active_tracking_rl_torch.envs.types import EnvState

torch.set_num_threads(1)


def torch_cfg(jax_cfg) -> TorchEnvConfig:
    """The port's EnvConfig with the same field values."""
    fields = {f: getattr(jax_cfg, f)
              for f in TorchEnvConfig.__dataclass_fields__}
    return TorchEnvConfig(**fields)


def _map_draws(cfg, key):
    """generate_block_map(cfg, key)."""
    k_ratio, k_perm = jax.random.split(key)
    return dict(obstacle_u=jax.random.uniform(k_ratio),
                perm=jax.random.permutation(k_perm, (cfg.maze_size - 2) ** 2))


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
    """nav_tape(cfg, key, ...): candidates from k_cand, planB from k_scan."""
    cells = cfg.maze_size ** 2
    k_cand, k_scan = jax.random.split(key)
    return dict(
        candidates=jax.vmap(lambda k: jax.random.gumbel(k, (cells,)))(
            jax.random.split(k_cand, cfg.nav_goal_candidates - 1)),
        planb=jax.vmap(lambda k: jax.random.randint(
            k, (), 0, cfg.num_actions, jnp.int8))(
                jax.random.split(k_scan, cfg.tape_len)))


def _reset_draws(cfg, key):
    """reset(cfg, key): map, spawns and tape keys split three ways."""
    k_map, k_spawn, k_tape = jax.random.split(key, 3)
    return {**_map_draws(cfg, k_map), **_spawn_draws(cfg, k_spawn),
            **_nav_draws(cfg, k_tape)}


@functools.lru_cache(maxsize=None)
def _batched(fn, cfg):
    return jax.jit(jax.vmap(functools.partial(fn, cfg)))


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def map_draws(jax_cfg, keys) -> MapDraws:
    d = _torch(_batched(_map_draws, jax_cfg)(keys))
    return MapDraws(d["obstacle_u"], d["perm"].long())


def spawn_draws(jax_cfg, keys) -> SpawnDraws:
    d = _torch(_batched(_spawn_draws, jax_cfg)(keys))
    return SpawnDraws(d["tracker"], d["goals"], d["retry"], d["target"])


def nav_draws(jax_cfg, keys) -> NavDraws:
    d = _torch(_batched(_nav_draws, jax_cfg)(keys))
    return NavDraws(d["candidates"], d["planb"])


def reset_draws(jax_cfg, keys) -> ResetDraws:
    """The draws `reset(cfg, key)` makes for each key of `keys` (n, 2)."""
    d = _torch(_batched(_reset_draws, jax_cfg)(keys))
    nav = (NavDraws(d["candidates"], d["planb"])
           if jax_cfg.target_mode == "Nav" else None)
    return ResetDraws(MapDraws(d["obstacle_u"], d["perm"].long()),
                      SpawnDraws(d["tracker"], d["goals"], d["retry"],
                                 d["target"]), nav)


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
