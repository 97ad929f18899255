"""Reset and step of the port's env against the JAX package's TrackEnv, bit
for bit, for six ids that between them cover every map (Maze, Block, Empty),
every observation (Partial, Full) and every target (Nav, Ram, RPF, PZR, Far,
Adv); and every one of the 72 ids resets and steps in the port.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from active_tracking_rl_tpu import config as jconfig
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_torch import config as tconfig
from active_tracking_rl_torch.envs import env as tenv
from active_tracking_rl_torch.ops.noise import Threefry
from tests.torch_draws import assert_state_equal, batch_draws, torch_cfg

FAST = dict(nav_goal_candidates=4, flood_iters=96, tape_len=96)

IDS = ["Track2D-MazePartialNav-v0", "Track2D-BlockFullRam-v1",
       "Track2D-EmptyFullRPF-v0", "Track2D-MazeFullPZR-v1",
       "Track2D-BlockPartialFar-v0", "Track2D-MazePartialAdv-v0"]


@functools.lru_cache(maxsize=None)
def _jax_fns(cfg, n):
    env = JaxEnv(cfg)
    return jax.jit(lambda k: env.reset_batch(k, n)), jax.jit(env.step_batch)


@pytest.mark.parametrize("env_id", IDS)
def test_reset_and_step_match_jax(env_id):
    cfg = dataclasses.replace(jconfig.parse_env_id(env_id), **FAST)
    n = 4
    key = jax.random.PRNGKey(80)
    reset_j, step_j = _jax_fns(cfg, n)
    state, obs = reset_j(key)
    tc = torch_cfg(cfg)
    tstate, tobs = tenv.reset(tc, batch_draws(cfg, key, n))
    assert_state_equal(tstate, state)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
    rng = np.random.RandomState(1)
    for _ in range(25):
        a = rng.randint(0, 4, size=(n, 2)).astype(np.int32)
        state, obs, rew, done, _ = step_j(state, a)
        tstate, tobs, trew, tdone, _ = tenv.step(tc, tstate,
                                                 torch.from_numpy(a))
        assert_state_equal(tstate, state)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(rew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(done))


@pytest.mark.parametrize("env_id", tconfig.env_ids())
def test_every_id_resets_and_steps(env_id):
    """Small tapes and few goals keep this quick; the shapes are the id's."""
    cfg = dataclasses.replace(tconfig.parse_env_id(env_id), tape_len=16,
                              nav_goal_candidates=2, flood_iters=32)
    env = tenv.TrackEnv(cfg, "cpu")
    state, obs = env.reset_batch(2, Threefry().manual_seed(0))
    assert obs.shape == (2,) + env.obs_shape and obs.dtype == torch.uint8
    state, obs, rew, done, _ = env.step(state, torch.zeros((2, 2),
                                                           dtype=torch.int32))
    assert obs.shape == (2,) + env.obs_shape
    assert rew.shape == (2, 2) and torch.isfinite(rew).all()
    assert state.tape.shape == (2, 16)
    if not cfg.scripted:
        assert not state.tape.any()
