"""Blocked pool consumption through the train step: the port's
``make_train_step(..., pool_blocks=2)`` against the JAX package's from the
same params, carry, reset pool and sampling noise.

With d pool blocks, batch and pool split into d equal blocks and block i
resets only from pool block i under its own pointer: the single-process
description of d data-parallel ranks (tests/test_parallel.py holds JAX's
sharded step to it at 8 blocks), and the yardstick of the port's ranks
(tests/test_torch_parallel.py). Episodes are cut to 5 steps so every row
ends inside the 8-step rollout and each block's pointer moves.

The reset pool is the port's own reset of JAX's pool draws
(tests/torch_draws.py), and must equal JAX's pool bit for bit. Integer
paths (env state, frame stack, the (2,) pointer, episode counts) match bit
for bit; loss and parameters to 1e-5 relative (parameters also 1e-6
absolute, as in tests/test_torch_learner.py: one SharedAdam step moves a
parameter by at most ~lr); the other float metrics to the learner tests'
gradient tolerance, rtol 1e-4 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.config import TrainConfig as JTrainConfig
from active_tracking_rl_tpu.config import parse_env_id
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.rl.learner import make_optimizer_for as j_opt_for
from active_tracking_rl_tpu.rl.learner import make_train_step as j_train_step
from active_tracking_rl_tpu.rl.rollout import TrainCarry as JCarry
from active_tracking_rl_torch.config import NetConfig, TrainConfig
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import build_model, params_from_flax
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.learner import init_pool_ptr, make_train_step
from active_tracking_rl_torch.rl.optim import make_optimizer_for
from active_tracking_rl_torch.rl.rollout import TrainCarry
from tests.torch_draws import (assert_state_equal, batch_draws, step_noise,
                               torch_cfg, torch_state)

ENV_ID = "Track2D-BlockPartialNav-v0"
REDUCED = dict(nav_goal_candidates=4, flood_iters=96, tape_len=96,
               max_episode_steps=5)
B, P, T, BLOCKS = 8, 6, 8, 2
REL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    ecfg = dataclasses.replace(parse_env_id(ENV_ID), **REDUCED)
    jenv = JaxEnv(ecfg)
    jt = JTrainConfig(env_id=ENV_ID, num_envs=B, reset_pool=P, num_steps=T,
                      train_mode=0)
    jn = JNetConfig.from_name("maze-lstm", aux="none")
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    params = jm.init(jax.random.PRNGKey(0))
    opt = j_opt_for(jn, jt, params)
    state, obs = jax.jit(lambda k: jenv.reset_batch(k, B))(
        jax.random.PRNGKey(1))
    pool_key = jax.random.PRNGKey(2)
    pool_state, pool_obs = jax.jit(lambda k: jenv.reset_batch(k, P))(pool_key)
    hx = jnp.zeros((B, 2, jn.rnn_out), jnp.float32)
    carry = JCarry(state, obs[:, :, None], hx, hx, jax.random.PRNGKey(3))
    step = jax.jit(j_train_step(jm, jenv, jn, jt, opt, external_pool=True,
                                pool_blocks=BLOCKS))
    p1, _, c1, m1, ptr1 = step(params, opt.init(params), carry, jnp.int32(0),
                               (pool_state, pool_obs,
                                jnp.zeros((BLOCKS,), jnp.int32)))

    tc = torch_cfg(ecfg)
    env = TrackEnv(tc, "cpu")
    tpool_state, tpool_obs = env.reset(batch_draws(ecfg, pool_key, P))
    tt = TrainConfig(env_id=ENV_ID, num_envs=B, reset_pool=P, num_steps=T,
                     train_mode=0)
    tn = NetConfig.from_name("maze-lstm", aux="none")
    model = build_model(tn, tc.num_actions, tc.obs_shape, device="cpu")
    model.load_state_dict(params_from_flax(_host(params)))
    ts = make_train_step(model, env, tn, tt, make_optimizer_for(model, tt),
                         pool_blocks=BLOCKS)
    tcarry = TrainCarry(torch_state(state),
                        torch.from_numpy(np.array(obs))[:, :, None],
                        torch.zeros(B, 2, 128), torch.zeros(B, 2, 128),
                        Threefry().manual_seed(0))
    tc1, tm1, tptr1 = ts(tcarry, 0, (tpool_state, tpool_obs,
                                     init_pool_ptr(BLOCKS, device="cpu")),
                         step_noise(carry.key, T, B, tc.num_actions))
    return dict(jax=(_host(p1), c1, m1, ptr1, pool_state, pool_obs),
                torch=(model.state_dict(), tc1, tm1, tptr1, tpool_state,
                       tpool_obs))


def test_pool_from_jax_draws_is_jax_pool(setup):
    *_, pool_state, pool_obs = setup["jax"]
    *_, tpool_state, tpool_obs = setup["torch"]
    assert_state_equal(tpool_state, pool_state)
    np.testing.assert_array_equal(tpool_obs.numpy(), np.asarray(pool_obs))


def test_blocked_step_integer_paths_bit_exact(setup):
    _, c1, m1, ptr1, *_ = setup["jax"]
    _, tc1, tm1, tptr1, *_ = setup["torch"]
    assert_state_equal(tc1.env_state, c1.env_state)
    np.testing.assert_array_equal(tc1.obs_stack.numpy(),
                                  np.asarray(c1.obs_stack))
    assert tptr1.shape == (BLOCKS,)
    np.testing.assert_array_equal(tptr1.numpy(), np.asarray(ptr1))
    assert float(tm1.ep_count) == float(m1.ep_count) >= B
    np.testing.assert_array_equal(tm1.ep_len.numpy(), np.asarray(m1.ep_len))


def test_blocked_step_loss_and_params_match_jax(setup):
    p1, _, m1, *_ = setup["jax"]
    tp1, _, tm1, *_ = setup["torch"]
    np.testing.assert_allclose(tm1.loss.item(), float(m1.loss), **REL)
    for name in ("policy_loss", "value_loss", "entropy", "ep_return",
                 "grad_norm"):
        np.testing.assert_allclose(getattr(tm1, name).numpy(),
                                   np.asarray(getattr(m1, name)),
                                   **METRIC_TOL, err_msg=name)
    for name, w in params_from_flax(p1).items():
        np.testing.assert_allclose(tp1[name].numpy(), w.numpy(), **PARAM_TOL,
                                   err_msg=name)


def test_in_step_pool_takes_blocked_pointer():
    """pool=None generates the pool inside the step from the carry's
    generator and starts a (d,) pointer at zero: the same step as the pool
    made from the same generator state and passed with init_pool_ptr(d)."""
    ecfg = torch_cfg(dataclasses.replace(parse_env_id(ENV_ID), **REDUCED))
    env = TrackEnv(ecfg, "cpu")
    tt = TrainConfig(env_id=ENV_ID, num_envs=B, reset_pool=P, num_steps=T,
                     train_mode=0)
    tn = NetConfig.from_name("maze-lstm", aux="none")
    outs = []
    for external in (False, True):
        model = build_model(tn, ecfg.num_actions, ecfg.obs_shape,
                            device="cpu",
                            generator=Threefry().manual_seed(0))
        gen = Threefry().manual_seed(5)
        state, obs = env.reset_batch(B, gen)
        carry = TrainCarry(state, obs[:, :, None], torch.zeros(B, 2, 128),
                           torch.zeros(B, 2, 128), gen)
        step = make_train_step(model, env, tn, tt,
                               make_optimizer_for(model, tt),
                               pool_blocks=BLOCKS)
        if external:
            from active_tracking_rl_torch.rl.learner import draw_step_noise
            noise = draw_step_noise(T, B, env.num_actions, gen, env.device)
            pool = (*env.reset_batch(P, gen),
                    init_pool_ptr(BLOCKS, device="cpu"))
            outs.append(step(carry, 0, pool, noise) + (model,))
        else:
            outs.append(step(carry, 0) + (model,))
    (c_a, m_a, ptr_a, model_a), (c_b, m_b, ptr_b, model_b) = outs
    assert ptr_a.shape == (BLOCKS,) and torch.equal(ptr_a, ptr_b)
    assert float(m_a.ep_count) >= B
    for f in dataclasses.fields(c_a.env_state):
        assert torch.equal(getattr(c_a.env_state, f.name),
                           getattr(c_b.env_state, f.name)), f.name
    assert torch.equal(m_a.loss, m_b.loss)
    for (k, a), b in zip(model_a.state_dict().items(),
                         model_b.state_dict().values()):
        assert torch.equal(a, b), k
