"""Rollout rematerialization and the bf16 model of the port.

Remat (``TrainConfig.remat``, ``torch.utils.checkpoint`` around each
rollout step's forward) is a pure recomputation: one train step with it and
one without, from the same state, give equal losses and gradients bit for
bit on the CPU, for an LSTM and a GRU network.

bf16 mirrors tests/test_bf16.py: the port's bf16 forward against its f32
forward at that test's tolerance (atol = rtol = 0.05, greedy agreement >=
0.75), parameters stay float32, and a bf16 train step is finite. The port's
bf16 forward against JAX's bf16 forward, from the same parameters: atol =
rtol = 1e-4. Both round the same conv, fc and cell-matmul inputs to
bfloat16; on the CPU the two then agree to a few float32 ulps (at most
3e-7 on values of about 0.1 when the test was written), and 1e-4 leaves
room for the reductions' order while staying far below the 2^-8 relative
step that one more bfloat16 rounding of an activation would cause.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_torch.config import NetConfig, TrainConfig, parse_env_id
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import build_model, params_from_flax
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.learner import (draw_step_noise,
                                                 init_pool_ptr, make_train_step)
from active_tracking_rl_torch.rl.optim import make_optimizer_for
from active_tracking_rl_torch.rl.rollout import init_carry
from tests.torch_learner_pair import FAST

B, P, T = 8, 8, 8


def _train_step(network, env_id, remat, bf16=False, mode=-1):
    """One train step from seed-0 state -> (loss, {name: grad}, model)."""
    ecfg = dataclasses.replace(parse_env_id(env_id), **FAST)
    env = TrackEnv(ecfg, "cpu")
    tcfg = TrainConfig(env_id=env_id, num_envs=B, reset_pool=P, num_steps=T,
                       train_mode=mode, remat=remat, bf16=bf16)
    ncfg = dataclasses.replace(NetConfig.from_name(network), bf16=bf16)
    gen = Threefry().manual_seed(0)
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, device="cpu",
                        generator=gen)
    carry = init_carry(env, ncfg, B, gen)
    pool = (*env.reset_batch(P, gen), init_pool_ptr(device="cpu"))
    noise = draw_step_noise(T, B, ecfg.num_actions, gen, "cpu")
    # lr 0: the step leaves the parameters as they were
    opt = make_optimizer_for(model, dataclasses.replace(tcfg, lr=0.0))
    step = make_train_step(model, env, ncfg, tcfg, opt)
    _, metrics, _ = step(carry, mode, pool, noise)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return metrics, grads, model


@pytest.mark.parametrize("network,env_id", [
    ("tat-maze-lstm", "Track2D-BlockPartialPZR-v0"),
    ("maze-gru", "Track2D-BlockPartialNav-v0")])
def test_remat_gradients_bit_identical(network, env_id):
    m1, g1, _ = _train_step(network, env_id, remat=True)
    m0, g0, _ = _train_step(network, env_id, remat=False)
    assert torch.equal(m1.loss, m0.loss)
    assert torch.equal(m1.grad_norm, m0.grad_norm)
    assert set(g1) == set(g0) and g1
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name


def _forward_inputs(ecfg):
    rng = np.random.RandomState(1)
    obs = rng.uniform(0.0, 6.0, (4, 2, 1) + ecfg.obs_shape + (1,)).astype(
        np.float32)
    return obs, np.zeros((4, 2, 128), np.float32)


def test_bf16_forward_close_to_f32_and_params_f32():
    ecfg = dataclasses.replace(parse_env_id("Track2D-EmptyPartialPZR-v0"),
                               **FAST)
    n32 = NetConfig.from_name("tat-maze-lstm")
    n16 = dataclasses.replace(n32, bf16=True)
    gen = Threefry().manual_seed(0)
    m32 = build_model(n32, ecfg.num_actions, ecfg.obs_shape, device="cpu",
                      generator=gen)
    m16 = build_model(n16, ecfg.num_actions, ecfg.obs_shape, device="cpu")
    m16.load_state_dict(m32.state_dict())   # one state dict, both precisions
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    obs, hx = map(torch.from_numpy, _forward_inputs(ecfg))
    with torch.no_grad():
        o32 = m32.step_both(obs, hx, hx, None, test=True)
        o16 = m16.step_both(obs, hx, hx, None, test=True)
    assert o16[0].dtype == torch.float32     # heads stay float32
    assert o16[4].dtype == torch.float32     # so does the recurrent state
    np.testing.assert_allclose(o16[0].numpy(), o32[0].numpy(), atol=0.05,
                               rtol=0.05)
    assert (o16[1] == o32[1]).float().mean() >= 0.75


@pytest.mark.parametrize("name,env_id", [
    ("tat-maze-lstm", "Track2D-EmptyPartialPZR-v0"),
    ("icml-gru", "Track2D-EmptyPartialPZR-v0"),
    ("tat-cnn-lstm", "Track2D-EmptyFullPZR-v0")])
def test_bf16_forward_matches_jax_bf16(name, env_id):
    ecfg = parse_env_id(env_id)
    jn = dataclasses.replace(JNetConfig.from_name(name), bf16=True)
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tn = dataclasses.replace(NetConfig.from_name(name), bf16=True)
    tm = build_model(tn, ecfg.num_actions, ecfg.obs_shape, device="cpu")
    tm.load_state_dict(params_from_flax(params))
    obs, hx = _forward_inputs(ecfg)
    want = jm.step_both(params, jnp.asarray(obs), hx, hx,
                        jax.random.PRNGKey(0), test=True)
    with torch.no_grad():
        got = tm.step_both(*map(torch.from_numpy, (obs, hx, hx)), None,
                           test=True)
    for i, what in ((0, "values"), (4, "hx"), (5, "cx")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=1e-4, rtol=1e-4, err_msg=what)


def test_bf16_train_step_is_finite_and_params_stay_f32():
    metrics, grads, model = _train_step("tat-maze-lstm",
                                        "Track2D-BlockPartialPZR-v0",
                                        remat=True, bf16=True)
    assert torch.isfinite(metrics.loss) and torch.isfinite(metrics.grad_norm)
    for p in model.parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())
