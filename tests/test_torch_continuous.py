"""Continuous heads and single-player models of the port against the JAX
package: ``sample_continuous`` and ``eval_continuous`` at JAX's own normal
draws (with the clamps binding on mu and on the action), ``wrap_action``,
the continuous A3C and TAT forwards on flax params converted by
``params_from_flax`` (the sigma head included), ``step_both`` two-player
and single at JAX's noise, and the ``params_to_flax`` round trip of a
single and of a continuous model.

Tolerances: the forwards to rtol 1e-5 / atol 1e-5, as in
tests/test_torch_nets.py (float32 on both sides, only the reduction order
of convs and matmuls differs); the heads' statistics to rtol 1e-4 / atol
1e-5; discrete actions and the converters exactly.
"""

import jax
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.models import heads as jheads
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.rl.host_loop import wrap_action as jwrap
from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.models import heads
from active_tracking_rl_torch.models.dueling import (build_model,
                                                     params_from_flax,
                                                     params_to_flax)
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.host_loop import wrap_action

TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
B, A, HW = 5, 3, (13, 13)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _both(name, single=False, seed=0, num_actions=A):
    jm = jbuild(JNetConfig.from_name(name), num_actions, HW, single=single)
    params = _np(jm.init(jax.random.PRNGKey(seed)))
    tm = build_model(NetConfig.from_name(name), num_actions, HW, device="cpu",
                     single=single)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _assert_tree_equal(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_tree_equal(got[k], w, f"{path}/{k}")
        else:
            g = got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            assert g.tobytes() == w.tobytes(), f"{path}/{k}"


def test_sample_continuous_matches_jax_at_its_draws():
    rng = np.random.default_rng(0)
    # mu beyond [-1, 1] on some rows, a large variance on others, so that
    # both clamps bind
    mu = rng.normal(0.0, 1.5, (64, A)).astype(np.float32)
    sigma_raw = rng.normal(0.0, 2.0, (64, A)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jheads.sample_continuous(mu, sigma_raw, key)
    eps = jax.random.normal(key, mu.shape)
    with torch.no_grad():
        got = heads.sample_continuous(_t(mu), _t(sigma_raw), _t(eps),
                                      test=True)
    assert (np.abs(mu) > 1).any()
    assert (np.abs(np.asarray(want.raw_action)) > 1).any()
    for name in ("raw_action", "action", "entropy", "log_prob"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   **STAT_TOL, err_msg=name)
    assert (got.action.abs() <= 1).all()
    assert not got.raw_action.requires_grad


def test_eval_continuous_matches_jax():
    rng = np.random.default_rng(3)
    mu = rng.normal(0.0, 1.2, (32, 2)).astype(np.float32)
    sigma_raw = rng.normal(0.0, 1.5, (32, 2)).astype(np.float32)
    x = rng.normal(0.0, 1.5, (32, 2)).astype(np.float32)
    want = jheads.eval_continuous(mu, sigma_raw, x)
    got = heads.eval_continuous(_t(mu), _t(sigma_raw), _t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STAT_TOL)


def test_eval_continuous_reproduces_the_sample_at_the_raw_action():
    """The replay's premise: the density at the stored raw sample is the
    sampled log-prob; at the clamped action it is not."""
    mu = torch.full((8, 1), 0.9)
    sigma_raw = torch.full((8, 1), 3.0)
    s = heads.sample_continuous(mu, sigma_raw,
                                torch.linspace(-2.0, 2.0, 8)[:, None])
    clipped = s.raw_action.abs() > 1
    assert clipped.any()
    _, lp_raw = heads.eval_continuous(mu, sigma_raw, s.raw_action)
    _, lp_act = heads.eval_continuous(mu, sigma_raw, s.action)
    torch.testing.assert_close(lp_raw, s.log_prob, rtol=0, atol=0)
    assert not torch.allclose(lp_raw[clipped], lp_act[clipped])


def test_wrap_action_matches_jax():
    a = np.array([[-1.0, 0.0], [1.0, 0.5], [0.3, -0.7]], np.float32)
    for low, high in (([0.0, -30.0], [100.0, 30.0]), (-1.0, 1.0),
                      (np.full(2, -2.0), np.full(2, 2.0))):
        got = wrap_action(a, low, high)
        want = jwrap(a, low, high)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["maze-lstm-continuous",
                                  "tat-maze-lstm-continuous"])
def test_continuous_forwards_match_flax(name):
    jm, params, tm = _both(name)
    assert "Dense_1" in params["player0"]["PolicyNet_0"]
    rng = np.random.RandomState(1)
    obs0 = rng.randint(0, 5, (B, 1) + HW + (1,)).astype(np.float32)
    obs1 = rng.randint(0, 5, (B, 1) + HW + (1,)).astype(np.float32)
    hx = rng.randn(B, 128).astype(np.float32)
    cx = rng.randn(B, 128).astype(np.float32)
    a0 = np.clip(rng.randn(B, A), -1, 1).astype(np.float32)
    want0 = jm.tracker_fwd(params, obs0, hx, cx)
    want1 = jm.target_fwd(params, obs0, obs1, hx, cx, a0)
    with torch.no_grad():
        got0 = tm.tracker_fwd(_t(obs0), _t(hx), _t(cx))
        got1 = tm.target_fwd(_t(obs0), _t(obs1), _t(hx), _t(cx), _t(a0))
    for got, want in ((got0, want0), (got1, want1)):
        for field in ("value", "logits", "sigma", "h", "c", "r_pred"):
            w = getattr(want, field)
            if w is None:
                assert getattr(got, field) is None, field
                continue
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(w), **TOL, err_msg=field)
    assert (np.abs(got0.logits.numpy()) < 1).all()       # softsign mu
    if "tat" in name:    # the target reads the float action itself
        a_hi = tm.target_fwd(_t(obs0), _t(obs1), _t(hx), _t(cx),
                             torch.ones(B, A))
        assert not torch.allclose(a_hi.value, got1.value)


def _assert_step_close(got, want, discrete):
    names = ["values", "actions", "entropies", "log_probs", "hx", "cx",
             "r_pred"]
    assert len(got) == len(want) == 7
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == tuple(np.shape(w)), name
        if name == "actions" and discrete:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **STAT_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("name,single", [
    ("tat-maze-lstm-continuous", False), ("maze-lstm-continuous", False),
    ("maze-lstm-continuous", True), ("maze-lstm", True)])
def test_step_both_matches_jax_at_its_noise(name, single):
    jm, params, tm = _both(name, single=single, seed=2)
    p = 1 if single else 2
    rng = np.random.RandomState(5)
    obs = rng.randint(0, 5, (B, p, 1) + HW + (1,)).astype(np.float32)
    hx = rng.randn(B, p, 128).astype(np.float32)
    cx = rng.randn(B, p, 128).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jax.jit(jm.step_both)(params, obs, hx, cx, key)
    # step_both splits its key into the tracker's and the target's draws
    draw = (jax.random.normal if "continuous" in name
            else jax.random.gumbel)
    noise = np.stack([np.asarray(draw(k, (B, A)))
                      for k in jax.random.split(key)[:p]], axis=1)
    with torch.no_grad():
        got = tm.step_both(_t(obs), _t(hx), _t(cx), _t(noise))
    _assert_step_close(got, want, discrete="continuous" not in name)
    if "continuous" in name:
        assert tuple(got[1].shape) == (B, p, A)
    if single:
        assert got[6] is None and tm.player1 is None


@pytest.mark.parametrize("name,single", [
    ("maze-lstm", True), ("maze-lstm-continuous", True),
    ("tat-maze-lstm-continuous", False), ("tat-cnn-gru-continuous", False)])
def test_converters_round_trip(name, single):
    _, params, tm = _both(name, single=single)
    sd = params_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    assert all(tm.state_dict()[k].shape == v.shape for k, v in sd.items())
    assert set(params) == ({"player0"} if single else {"player0", "player1"})
    _assert_tree_equal(params_to_flax(tm.state_dict(),
                                      NetConfig.from_name(name)), params)


def test_reset_parameters_initializes_the_sigma_head_and_no_player1():
    tm = build_model(NetConfig.from_name("maze-lstm-continuous"), A, HW,
                     device="cpu", single=True,
                     generator=Threefry().manual_seed(0))
    assert tm.player1 is None
    sigma = tm.player0.sigma.requires_grad_(False)
    bound = np.sqrt(6.0 / (128 + A))
    assert float(sigma.weight.abs().max()) <= bound
    assert float(sigma.weight.std()) > bound / 4
    assert not sigma.bias.any()
