"""The port's tracker-aware target (TATPlayer) and the joint step with it
(DuelingModel.step_both, sampled and greedy; bootstrap_values) against the
flax modules of the JAX package, on params converted by
``params_from_flax``; and the committed AD-VAT checkpoint's greedy actions.

Tolerance: values, logits, entropies, log-probabilities, recurrent state
and r_pred agree to rtol 1e-5 / atol 1e-5. Both sides run float32 on the
CPU; only the summation order of the conv and matmul reductions differs
(XLA vs PyTorch's CPU kernels), a few ulp (~1e-7 relative) per layer.
Actions are compared exactly: sampled ones take argmax(logits + the same
Gumbel noise), greedy ones argmax p.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.config import parse_env_id
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.rl.learner import bootstrap_values as j_boot
from active_tracking_rl_tpu.rl.rollout import TrainCarry as JCarry
from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.models.dueling import (TATPlayer, build_model,
                                                     params_from_flax)
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.learner import bootstrap_values
from active_tracking_rl_torch.rl.rollout import TrainCarry

TOL = dict(rtol=1e-5, atol=1e-5)
B, A = 8, 4
RUN = Path(__file__).resolve().parents[1] / (
    "runs/r5-advat-s3-ext2/Track2D-BlockPartialPZR-v0/Aug21_19-24")


def _obs(rng, b, k=1):
    """(B, 2, k, 13, 13, 1) float observations with the env's cell codes."""
    return rng.choice([0, 1, 2, 4], size=(b, 2, k, 13, 13, 1)).astype(
        np.float32)


def _models(stack=1, seed=0):
    jn = JNetConfig.from_name("tat-maze-lstm", stack_frames=stack)
    jm = jbuild(jn, A, (13, 13))
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(seed)))
    tm = build_model(NetConfig.from_name("tat-maze-lstm", stack_frames=stack),
                     A, (13, 13), device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _gumbel(key):
    """The noise step_both(key) samples both players with."""
    k0, k1 = jax.random.split(key)
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.gumbel(k, (B, A))) for k in (k0, k1)], axis=1))


def _assert_step_equal(got, want):
    names = ("values", "actions", "entropies", "log_probs", "hx", "cx",
             "r_pred")
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy()
        if name == "actions":
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            np.testing.assert_allclose(g, np.asarray(w), **TOL, err_msg=name)


def test_converter_covers_every_tat_parameter():
    _, params, tm = _models()
    assert isinstance(tm.player1, TATPlayer)
    sd = params_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    assert {"player1.fc_action_tracker.weight", "player1.reward_aux.bias"} \
        <= set(sd)
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in tm.parameters())
    # the target's encoder reads 2k frames: its fc input doubles
    assert tm.player1.encoder.fc.in_features \
        == 2 * tm.player0.encoder.fc.in_features


def test_reset_parameters_follows_the_reference_init():
    """Every Linear of the TAT player U(-b, b), b = sqrt(6/(in+out)), bias 0."""
    tm = build_model(NetConfig.from_name("tat-maze-lstm"), A, (13, 13),
                     device="cpu", generator=Threefry().manual_seed(0))
    for lin in (tm.player1.fc_action_tracker, tm.player1.reward_aux):
        out_f, in_f = lin.weight.shape
        b = np.sqrt(6.0 / (in_f + out_f))
        w = lin.weight.detach()
        assert float(w.abs().max()) <= b and float(w.std()) > b / 4
        assert not lin.bias.detach().any()


@pytest.mark.parametrize("stack", [1, 2])
def test_target_forward_matches_flax(stack):
    """target_fwd: both observations joined on the stack axis, the tracker's
    action one-hot through fc_action_tracker; every output of PlayerOut."""
    jm, params, tm = _models(stack, seed=stack)
    rng = np.random.RandomState(stack)
    obs = _obs(rng, B, stack)
    h = rng.randn(B, 128).astype(np.float32)
    c = rng.randn(B, 128).astype(np.float32)
    a = rng.randint(0, A, size=B).astype(np.int32)
    want = jm.target_fwd(params, obs[:, 0], obs[:, 1], h, c, a)
    got = tm.target_fwd(*(torch.from_numpy(x) for x in
                          (obs[:, 0], obs[:, 1], h, c, a)))
    for name in ("value", "logits", "h", "c", "r_pred"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)
    assert got.r_pred.shape == (B, 1)
    assert tm.tracker_fwd(*(torch.from_numpy(x) for x in
                            (obs[:, 0], h, c))).r_pred is None


@pytest.mark.parametrize("test", [False, True])
def test_step_both_matches_flax(test):
    """Sampled (by the same Gumbel noise) and greedy joint steps, r_pred as
    the seventh value."""
    jm, params, tm = _models()
    rng = np.random.RandomState(3)
    obs = _obs(rng, B)
    hx = rng.randn(B, 2, 128).astype(np.float32)
    cx = rng.randn(B, 2, 128).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jm.step_both(params, obs, hx, cx, key, test)
    got = tm.step_both(torch.from_numpy(obs), torch.from_numpy(hx),
                       torch.from_numpy(cx), None if test else _gumbel(key),
                       test)
    assert got[6].shape == (B, 1)
    _assert_step_equal(got, want)


def test_greedy_step_ignores_the_noise():
    _, _, tm = _models()
    rng = np.random.RandomState(4)
    obs, hx = torch.from_numpy(_obs(rng, B)), torch.zeros(B, 2, 128)
    base = tm.step_both(obs, hx, hx, None, test=True)
    noisy = tm.step_both(obs, hx, hx, 50 * torch.randn(B, 2, A), test=True)
    for x, y in zip(base, noisy):
        assert torch.equal(x, y)


def test_non_tat_model_returns_no_r_pred():
    tm = build_model(NetConfig.from_name("maze-lstm", aux="none"), A,
                     (13, 13), device="cpu",
                     generator=Threefry().manual_seed(0))
    out = tm.step_both(torch.zeros(B, 2, 1, 13, 13, 1),
                       torch.zeros(B, 2, 128), torch.zeros(B, 2, 128), None,
                       test=True)
    assert len(out) == 7 and out[6] is None


def test_tat_bootstrap_reads_the_fresh_tracker_sample():
    """V(s_T): the TAT target's value is conditioned on the tracker's action
    sampled at s_T. The port matches JAX's bootstrap_values from the same
    key's noise, and other noise (other tracker actions) moves the
    target's value and not the tracker's."""
    jm, params, tm = _models(seed=5)
    rng = np.random.RandomState(5)
    obs_stack = rng.choice([0, 1, 2, 4], size=(B, 2, 1, 13, 13)).astype(
        np.uint8)
    hx = rng.randn(B, 2, 128).astype(np.float32)
    cx = rng.randn(B, 2, 128).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(j_boot(jm, params, JCarry(None, obs_stack, hx, cx, None),
                             key))
    carry = TrainCarry(None, torch.from_numpy(obs_stack),
                       torch.from_numpy(hx), torch.from_numpy(cx), None)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (B, A))))
    got = bootstrap_values(tm, carry, gumbel)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # noise that forces each row's tracker action to a, for every a
    by_action = [bootstrap_values(tm, carry, 1e4 * torch.nn.functional.one_hot(
        torch.full((B,), a), A).float()) for a in range(A)]
    for v in by_action[1:]:
        assert torch.equal(v[:, 0], by_action[0][:, 0])
        assert not torch.allclose(v[:, 1], by_action[0][:, 1])


@pytest.fixture(scope="module")
def advat_checkpoint():
    """The committed AD-VAT run's best tracker and target, in both packages."""
    params = {
        "player0": serialization.msgpack_restore(
            (RUN / "tracker-best.msgpack").read_bytes()),
        "player1": serialization.msgpack_restore(
            (RUN / "target-best.msgpack").read_bytes())}
    jn = JNetConfig.from_name("tat-maze-lstm")
    jm = jbuild(jn, A, (13, 13))
    tm = build_model(NetConfig.from_name("tat-maze-lstm"), A, (13, 13),
                     device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def test_advat_checkpoint_greedy_actions_match_jax(advat_checkpoint):
    """16 episodes of Track2D-BlockPartialPZR-v0, 12 greedy joint steps
    driven by JAX's env and actions; at every step the port, fed the same
    observations and its own recurrent state, picks JAX's greedy actions
    and predicts its rewards."""
    jm, params, tm = advat_checkpoint
    n = 16
    env = JaxEnv(parse_env_id("Track2D-BlockPartialPZR-v0"))
    state, obs = jax.jit(lambda k: env.reset_batch(k, n))(
        jax.random.PRNGKey(0))
    step_env = jax.jit(env.step_batch)
    step_j = jax.jit(lambda o, h, c: jm.step_both(
        params, o, h, c, jax.random.PRNGKey(0), True))
    hx = jnp.zeros((n, 2, 128), jnp.float32)
    cx = hx
    thx = torch.zeros(n, 2, 128)
    tcx = thx.clone()
    acted = set()
    for t in range(12):
        o = np.asarray(obs, np.float32)[:, :, None, ..., None]
        want = step_j(o, hx, cx)
        got = tm.step_both(torch.from_numpy(o), thx, tcx, None, test=True)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                      err_msg=f"step {t}")
        np.testing.assert_allclose(got[6].detach().numpy(),
                                   np.asarray(want[6]), **TOL,
                                   err_msg=f"r_pred step {t}")
        acted.update(np.asarray(want[1]).ravel().tolist())
        hx, cx = want[4], want[5]
        thx, tcx = got[4].detach(), got[5].detach()
        state, obs, *_ = step_env(state, want[1])
    assert len(acted) > 1          # the trained players do not idle
