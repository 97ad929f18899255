"""The env package's public names against the JAX package's, on the CPU.

``make_env`` (and ``envs.make_env``), ``types.zeros_like_state`` and the
one-goal ``distance.distance_field`` / ``distance_field_sweep`` of
``active_tracking_rl_torch.envs`` against their namesakes in
``active_tracking_rl_tpu.envs``: configs field for field, templates and
fields bit for bit, on a few ids and small maps made from a numpy seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu import config as jcfg
from active_tracking_rl_tpu import envs as jenvs
from active_tracking_rl_tpu.envs import distance as jdist
from active_tracking_rl_tpu.envs import types as jtypes
from active_tracking_rl_torch import config as tcfg
from active_tracking_rl_torch import envs as tenvs
from active_tracking_rl_torch.envs import distance as tdist
from active_tracking_rl_torch.envs import types as ttypes
from active_tracking_rl_torch.envs.env import TrackEnv, make_env

IDS = ["Track2D-BlockPartialNav-v0", "Track2D-MazePartialPZR-v0",
       "Track2D-EmptyFullRam-v1", "Track2D-BlockPartialFar-v0"]
S = 20
#: JAX's one-goal functions, compiled once for every map and goal of S x S
J_FIELD = jax.jit(jdist.distance_field, static_argnums=2)
J_SWEEP = jax.jit(jdist.distance_field_sweep)


def _maze(seed: int, density: float) -> np.ndarray:
    """A walled S x S map with random inner walls."""
    rng = np.random.default_rng(seed)
    maze = (rng.random((S, S)) < density).astype(np.uint8)
    maze[0, :] = maze[-1, :] = maze[:, 0] = maze[:, -1] = 1
    return maze


def _goals(maze: np.ndarray, seed: int, n: int) -> np.ndarray:
    """n goals: free cells, and one on a wall (an all-INF field)."""
    rng = np.random.default_rng(seed + 100)
    free = np.argwhere(maze == 0)
    goals = free[rng.choice(len(free), n - 1, replace=False)]
    return np.concatenate([goals, [[0, 0]]]).astype(np.int32)


@pytest.mark.parametrize("env_id", IDS)
def test_make_env_matches_jax(env_id):
    want = dataclasses.asdict(jenvs.make_env(env_id).cfg)
    env = make_env(env_id, device="cpu")
    assert isinstance(env, TrackEnv)
    assert env.device == torch.device("cpu")
    assert dataclasses.asdict(env.cfg) == want
    assert tenvs.make_env is make_env and tenvs.TrackEnv is TrackEnv
    # a given cfg wins over the id, as in the JAX factory
    cfg = dataclasses.replace(tcfg.parse_env_id(env_id), max_episode_steps=7)
    jc = dataclasses.replace(jcfg.parse_env_id(env_id), max_episode_steps=7)
    assert make_env("unused", cfg, device="cpu").cfg == cfg
    assert dataclasses.asdict(jenvs.make_env("unused", jc).cfg) == \
        dataclasses.asdict(cfg)


def test_make_env_defaults_to_the_card():
    assert make_env(IDS[0]).device == torch.device("cuda")


@pytest.mark.parametrize("env_id", IDS)
def test_zeros_like_state_matches_jax(env_id):
    want = jtypes.zeros_like_state(jcfg.parse_env_id(env_id))
    got = ttypes.zeros_like_state(tcfg.parse_env_id(env_id), "cpu")
    assert isinstance(got, tenvs.EnvState) and got.num_rows == 1
    for f in dataclasses.fields(got):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name)
        assert g.device == torch.device("cpu"), f.name
        g = g.numpy()
        assert g.shape == (1, *w.shape), f.name
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g[0], w, err_msg=f.name)


@pytest.mark.parametrize("seed,density", [(0, 0.15), (1, 0.35), (2, 0.5)])
def test_distance_field_matches_jax(seed, density):
    maze = _maze(seed, density)
    goals = _goals(maze, seed, 3)
    tm = torch.from_numpy(maze)
    fields = []
    for g in goals:
        tg = torch.from_numpy(g)
        for iters in (0, 5, 3 * S):
            want = np.asarray(J_FIELD(jnp.asarray(maze), jnp.asarray(g),
                                      iters))
            got = tdist.distance_field(tm, tg, iters)
            assert got.dtype == torch.int16
            np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(J_SWEEP(jnp.asarray(maze), jnp.asarray(g)))
        got = tdist.distance_field_sweep(tm, tg)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)
        fields.append(want)
    # the batched form: one goal a map, (N, S, S) with (N, 2)
    tb = tm[None].expand(len(goals), S, S)
    np.testing.assert_array_equal(
        tdist.distance_field_sweep(tb, torch.from_numpy(goals)).numpy(),
        np.stack(fields))
    np.testing.assert_array_equal(
        tdist.distance_field(tb, torch.from_numpy(goals), 3 * S).numpy(),
        np.stack([np.asarray(J_FIELD(jnp.asarray(maze), jnp.asarray(g),
                                     3 * S)) for g in goals]))
