"""The AD-VAT slice as a whole: two train steps of the port with the
tracker-aware target (tat-maze-lstm on Track2D-BlockPartialPZR-v0, static
train mode -1, the aux reward head on), the first at mode 0 (the warmup)
and the second at mode -1, against the JAX package's ``make_train_step``
from the same params, carry and reset pool.

The port takes its sampling noise as tensors; the test re-derives it from
the keys that each JAX step splits (tests/torch_draws.py:step_noise).

Integer paths (env state, frame stack, pool pointer, episode counts) must
match bit for bit. Tolerance for the float paths, as in
tests/test_torch_learner.py: loss, pred_loss and gradients rtol 1e-4 /
atol 1e-5, updated params rtol 1e-5 / atol 1e-6. Both run float32 on the
CPU; the gradients are sums over 8 envs x 8 steps of backpropagated
products through conv, LSTM and heads, whose reductions associate
differently in XLA and PyTorch, amplified by the 8-step BPTT chain; a
SharedAdam step moves a parameter by at most ~lr.
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
from active_tracking_rl_torch.config import NetConfig, TrainConfig, preset
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import build_model, params_from_flax
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl import curriculum
from active_tracking_rl_torch.rl.learner import (init_learner, init_pool_ptr,
                                                 make_train_step)
from active_tracking_rl_torch.rl.optim import make_optimizer_for
from active_tracking_rl_torch.rl.rollout import TrainCarry
from tests.torch_draws import (assert_state_equal, capture_grads, step_noise,
                               torch_cfg, torch_state)

ENV_ID = "Track2D-BlockPartialPZR-v0"
B, P, T = 8, 8, 8
MODES = (0, -1)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def both_runs():
    """Per step: JAX's (params, grads, carry, metrics, ptr) and the port's
    (state_dict, grads, carry, metrics, ptr)."""
    ecfg = parse_env_id(ENV_ID)
    jenv = JaxEnv(ecfg)
    jt = JTrainConfig(env_id=ENV_ID, num_envs=B, reset_pool=P, num_steps=T,
                      train_mode=-1)
    jn = JNetConfig.from_name("tat-maze-lstm")
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    params = jm.init(jax.random.PRNGKey(0))
    opt = capture_grads(j_opt_for(jn, jt, params))
    reset = jax.jit(lambda k: jenv.reset_batch(k, B))
    state, obs = reset(jax.random.PRNGKey(1))
    pool_state, pool_obs = reset(jax.random.PRNGKey(2))
    hx = jnp.zeros((B, 2, jn.rnn_out), jnp.float32)
    carry = JCarry(state, obs[:, :, None], hx, hx, jax.random.PRNGKey(3))
    step = jax.jit(j_train_step(jm, jenv, jn, jt, opt, external_pool=True))

    tc = torch_cfg(ecfg)
    env = TrackEnv(tc, "cpu")
    tt = TrainConfig(env_id=ENV_ID, num_envs=B, reset_pool=P, num_steps=T,
                     train_mode=-1)
    tn = NetConfig.from_name("tat-maze-lstm")
    model = build_model(tn, tc.num_actions, tc.obs_shape, device="cpu")
    model.load_state_dict(params_from_flax(_host(params)))
    topt = make_optimizer_for(model, tt)
    ts = make_train_step(model, env, tn, tt, topt)
    tcarry = TrainCarry(torch_state(state),
                        torch.from_numpy(np.array(obs))[:, :, None],
                        torch.zeros(B, 2, 128), torch.zeros(B, 2, 128),
                        Threefry().manual_seed(0))
    tpool = (torch_state(pool_state), torch.from_numpy(np.array(pool_obs)))

    opt_state, ptr, tptr = opt.init(params), jnp.int32(0), init_pool_ptr(
        device="cpu")
    runs = []
    for mode in MODES:
        noise = step_noise(carry.key, T, B, tc.num_actions)
        params, opt_state, carry, m, ptr = step(
            params, opt_state, carry, jnp.int32(mode),
            (pool_state, pool_obs, ptr))
        tcarry, tm, tptr = ts(tcarry, mode, (*tpool, tptr), noise)
        tgrads = {n: (p.grad.clone() if p.grad is not None
                      else torch.zeros_like(p))
                  for n, p in model.named_parameters()}
        runs.append(dict(
            jax=(_host(params), _host(opt_state[1]), carry, m, ptr),
            torch=({k: v.clone() for k, v in model.state_dict().items()},
                   tgrads, tcarry, tm, tptr)))
    return runs


@pytest.mark.parametrize("i", range(len(MODES)))
def test_advat_rollout_integer_paths_bit_exact(both_runs, i):
    _, _, c1, m1, ptr1 = both_runs[i]["jax"]
    _, _, tc1, tm1, tptr1 = both_runs[i]["torch"]
    assert_state_equal(tc1.env_state, c1.env_state)
    np.testing.assert_array_equal(tc1.obs_stack.numpy(),
                                  np.asarray(c1.obs_stack))
    assert int(tptr1) == int(ptr1)
    assert float(tm1.ep_count) == float(m1.ep_count)
    np.testing.assert_array_equal(tm1.ep_len.numpy(), np.asarray(m1.ep_len))


@pytest.mark.parametrize("i", range(len(MODES)))
def test_advat_loss_and_pred_loss_match_jax(both_runs, i):
    m1, tm1 = both_runs[i]["jax"][3], both_runs[i]["torch"][3]
    for name in ("loss", "pred_loss", "grad_norm"):
        np.testing.assert_allclose(getattr(tm1, name).item(),
                                   float(getattr(m1, name)), **GRAD_TOL,
                                   err_msg=name)
    for name in ("policy_loss", "value_loss", "entropy", "ep_return"):
        np.testing.assert_allclose(getattr(tm1, name).numpy(),
                                   np.asarray(getattr(m1, name)), **GRAD_TOL,
                                   err_msg=name)
    assert tm1.pred_loss.item() > 0
    # the aux loss is reported at every mode and enters the loss at -1 only
    players = tm1.policy_loss + 0.5 * tm1.value_loss
    want = players[0] + (players[1] + tm1.pred_loss if MODES[i] else 0.0)
    np.testing.assert_allclose(tm1.loss.item(), want.item(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("i", range(len(MODES)))
def test_advat_grads_match_jax(both_runs, i):
    grads = params_from_flax(both_runs[i]["jax"][1])
    tgrads = both_runs[i]["torch"][1]
    assert set(grads) == set(tgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(),
                                   **GRAD_TOL, err_msg=name)
    player1 = [g for n, g in grads.items() if n.startswith("player1")]
    if MODES[i] == 0:       # the target's loss and the aux loss are out
        assert all(not g.any() for g in player1)
    else:                   # reward_aux learns from the aux loss alone
        assert grads["player1.reward_aux.weight"].any()


@pytest.mark.parametrize("i", range(len(MODES)))
def test_advat_updated_params_match_jax(both_runs, i):
    want = params_from_flax(both_runs[i]["jax"][0])
    got = both_runs[i]["torch"][0]
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **PARAM_TOL,
                                   err_msg=name)


def test_advat_runs_from_its_own_generator_under_the_curriculum():
    """The AD-VAT preset at a small width, from init_learner: the curriculum
    picks mode 0 for the warmup iterations below init_step, then -1; the
    losses are finite, pred_loss enters at -1 only, and the target moves
    only once the joint loss trains it."""
    tt = dataclasses.replace(preset("advat-2d"), num_envs=B, reset_pool=P,
                             num_steps=T, init_step=3)
    tc = torch_cfg(parse_env_id(tt.env_id))
    env = TrackEnv(tc, "cpu")
    tn = NetConfig.from_name("tat-maze-lstm")
    model = build_model(tn, tc.num_actions, tc.obs_shape, device="cpu")
    state = init_learner(model, env, tn, tt, Threefry().manual_seed(0))
    ts = make_train_step(model, env, tn, tt, state.opt)
    cur, carry, modes = curriculum.CurriculumState.initial(tt), state.carry, []
    target = {k: v.clone() for k, v in model.player1.state_dict().items()}
    for it in range(1, 5):
        cur = curriculum.update(tt, cur, it)
        carry, m, _ = ts(carry, cur.mode)
        modes.append(cur.mode)
        assert torch.isfinite(m.loss) and float(m.pred_loss) > 0
        players = m.policy_loss + 0.5 * m.value_loss
        rest = m.loss - players[0] - (players[1] if cur.mode else 0.0)
        np.testing.assert_allclose(rest.item(),
                                   m.pred_loss.item() if cur.mode else 0.0,
                                   atol=1e-4)
        moved = any(not torch.equal(v, target[k])
                    for k, v in model.player1.state_dict().items())
        assert moved == (cur.mode == -1)
    assert modes == [0, 0, -1, -1]
