"""The slice as a whole: one train step of the port (rollout, bootstrap,
loss, backward, clipped SharedAdam) against the JAX package's
``make_train_step`` from the same params, carry and reset pool.

The port takes its sampling noise as tensors; the test re-derives it from
the keys that the JAX step splits (rl/rollout.py run_rollout, rl/learner.py
loss_fn, models/dueling.py step_both), so both sample the same actions.

Integer paths (env state, frame stack, pool pointer, episode counts) must
match bit for bit. Tolerance for the float paths: loss and gradients rtol
1e-4 / atol 1e-5, updated params rtol 1e-5 / atol 1e-6. Both run float32 on
the CPU; the gradients are sums over 8 envs x 8 steps of backpropagated
products through conv, LSTM and heads, whose reductions associate
differently in XLA and PyTorch (a few ulp per op, amplified by the 8-step
BPTT chain); one SharedAdam step moves a parameter by at most ~lr, so the
updated params agree more tightly in absolute terms.
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
from active_tracking_rl_torch.rl.learner import (init_learner, init_pool_ptr,
                                                 make_pool_fn, make_train_step)
from active_tracking_rl_torch.rl.optim import make_optimizer_for
from active_tracking_rl_torch.rl.rollout import TrainCarry
from tests.torch_draws import (assert_state_equal, capture_grads, step_noise,
                               torch_cfg, torch_state)

ENV_ID = "Track2D-BlockPartialNav-v0"
FAST = dict(nav_goal_candidates=4, flood_iters=96, tape_len=96)
B, P, T = 8, 8, 8
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def both_steps():
    ecfg = dataclasses.replace(parse_env_id(ENV_ID), **FAST)
    jenv = JaxEnv(ecfg)
    jt = JTrainConfig(env_id=ENV_ID, num_envs=B, reset_pool=P, num_steps=T,
                      train_mode=0)
    jn = JNetConfig.from_name("maze-lstm", aux="none")
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    params = jm.init(jax.random.PRNGKey(0))
    opt = capture_grads(j_opt_for(jn, jt, params))
    reset = jax.jit(lambda k: jenv.reset_batch(k, B))
    state, obs = reset(jax.random.PRNGKey(1))
    pool_state, pool_obs = reset(jax.random.PRNGKey(2))
    hx = jnp.zeros((B, 2, jn.rnn_out), jnp.float32)
    carry = JCarry(state, obs[:, :, None], hx, hx, jax.random.PRNGKey(3))
    step = jax.jit(j_train_step(jm, jenv, jn, jt, opt, external_pool=True))
    p1, (_, grads), c1, m1, ptr1 = step(
        params, opt.init(params), carry, jnp.int32(0),
        (pool_state, pool_obs, jnp.int32(0)))

    tc = torch_cfg(ecfg)
    env = TrackEnv(tc, "cpu")
    tt = TrainConfig(env_id=ENV_ID, num_envs=B, reset_pool=P, num_steps=T,
                     train_mode=0)
    tn = NetConfig.from_name("maze-lstm", aux="none")
    model = build_model(tn, tc.num_actions, tc.obs_shape, device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    topt = make_optimizer_for(model, tt)
    tcarry = TrainCarry(torch_state(state),
                        torch.from_numpy(np.array(obs))[:, :, None],
                        torch.zeros(B, 2, 128), torch.zeros(B, 2, 128),
                        Threefry().manual_seed(0))
    ts = make_train_step(model, env, tn, tt, topt)
    tc1, tm1, tptr1 = ts(tcarry, 0, (torch_state(pool_state),
                                     torch.from_numpy(np.array(pool_obs)),
                                     init_pool_ptr(device="cpu")),
                         step_noise(carry.key, T, B, tc.num_actions))
    tgrads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
              for n, p in model.named_parameters()}
    return dict(jax=(p1, grads, c1, m1, ptr1),
                torch=(model.state_dict(), tgrads, tc1, tm1, tptr1))


def test_slice_rollout_integer_paths_bit_exact(both_steps):
    _, _, c1, m1, ptr1 = both_steps["jax"]
    _, _, tc1, tm1, tptr1 = both_steps["torch"]
    assert_state_equal(tc1.env_state, c1.env_state)
    np.testing.assert_array_equal(tc1.obs_stack.numpy(),
                                  np.asarray(c1.obs_stack))
    assert int(tptr1) == int(ptr1)
    assert float(tm1.ep_count) == float(m1.ep_count)
    np.testing.assert_array_equal(tm1.ep_len.numpy(), np.asarray(m1.ep_len))


def test_slice_loss_matches_jax(both_steps):
    m1, tm1 = both_steps["jax"][3], both_steps["torch"][3]
    np.testing.assert_allclose(tm1.loss.item(), float(m1.loss), **GRAD_TOL)
    for name in ("policy_loss", "value_loss", "entropy", "ep_return"):
        np.testing.assert_allclose(getattr(tm1, name).numpy(),
                                   np.asarray(getattr(m1, name)), **GRAD_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tm1.grad_norm.item(), float(m1.grad_norm),
                               **GRAD_TOL)


def test_slice_grads_match_jax(both_steps):
    grads = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                    both_steps["jax"][1]))
    tgrads = both_steps["torch"][1]
    assert set(grads) == set(tgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(),
                                   **GRAD_TOL, err_msg=name)
    # train mode 0: the target's loss does not enter, its grads are zero
    assert all(not g.any() for n, g in grads.items() if n.startswith("player1"))


def test_slice_updated_params_match_jax(both_steps):
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   both_steps["jax"][0]))
    got = both_steps["torch"][0]
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **PARAM_TOL,
                                   err_msg=name)


def test_slice_runs_from_its_own_generator():
    """init_learner + three train steps with a fresh pool each (pool refresh
    1), then a reused pool with the pointer threaded through: finite losses,
    only player0 moves, and the pointer advances by the terminations."""
    tc = torch_cfg(dataclasses.replace(parse_env_id(ENV_ID), **FAST))
    env = TrackEnv(tc, "cpu")
    tt = TrainConfig(env_id=ENV_ID, num_envs=B, reset_pool=P, num_steps=T,
                     train_mode=0)
    tn = NetConfig.from_name("maze-lstm", aux="none")
    model = build_model(tn, tc.num_actions, tc.obs_shape, device="cpu")
    state = init_learner(model, env, tn, tt, Threefry().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ts = make_train_step(model, env, tn, tt, state.opt)
    carry = state.carry
    for _ in range(3):
        carry, m, _ = ts(carry, 0)
        assert torch.isfinite(m.loss) and torch.isfinite(m.grad_norm)
    pool = make_pool_fn(env, tt)(carry.generator)
    ptr, consumed = init_pool_ptr(device="cpu"), 0
    for _ in range(2):
        carry, m, ptr = ts(carry, 0, (*pool, ptr))
        consumed += int(m.ep_count)
    assert int(ptr) == consumed % P
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("player1"))
    assert any(not torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("player0"))
