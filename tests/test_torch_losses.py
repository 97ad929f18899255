"""The port's GAE, dueling loss and SharedAdam against the JAX package
(``ops/gae.py``, ``ops/losses.py``, the optax chain of ``rl/optim.py`` with
the train-mode mask of ``rl/learner.py``) and tests/oracles.py.

Tolerance: rtol 1e-5 / atol 1e-5 in float32. The arithmetic is the same
formula in the same order; only reductions (sums over T and over the
parameter tree for the clip norm) may associate differently. The per-row
losses sum T terms of magnitude up to ~20, where one float32 ulp is ~2e-6,
so a sum that cancels to near zero can differ by a few 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.config import TrainConfig as JTrainConfig
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.ops.gae import gae_returns as j_gae
from active_tracking_rl_tpu.ops.losses import dueling_loss as j_loss
from active_tracking_rl_tpu.rl.learner import make_optimizer_for as j_opt_for
from active_tracking_rl_tpu.rl.optim import make_optimizer as j_make_opt
from active_tracking_rl_torch.config import NetConfig, TrainConfig
from active_tracking_rl_torch.models.dueling import build_model, params_from_flax
from active_tracking_rl_torch.ops.gae import gae_returns
from active_tracking_rl_torch.ops.losses import dueling_loss
from active_tracking_rl_torch.rl.optim import (SharedAdam, clip_by_global_norm_,
                                               global_norm, make_optimizer_for)
from tests.oracles import gae_reference

TOL = dict(rtol=1e-5, atol=1e-5)
T, B = 8, 5


def _traj(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    done = rng.rand(T, B) < 0.2
    return dict(rewards=f(T, B, 2), values=f(T, B, 2), bootstrap=f(B, 2),
                log_probs=-np.abs(f(T, B, 2)), entropies=np.abs(f(T, B, 2)),
                done=done)


def test_gae_no_done_matches_reference_loop():
    d = _traj(0)
    r, v, bs = d["rewards"][:, 0, 0], d["values"][:, 0, 0], d["bootstrap"][0, 0]
    ret, gae = gae_returns(torch.from_numpy(r), torch.from_numpy(v),
                           torch.tensor(bs), torch.zeros(T, dtype=torch.bool),
                           0.9, 1.0)
    want_r, want_g = gae_reference(r, v, float(bs), 0.9, 1.0)
    np.testing.assert_allclose(ret.numpy(), want_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gae.numpy(), want_g, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tau", [1.0, 0.95])
def test_gae_with_dones_matches_jax(tau):
    d = _traj(1)
    want_r, want_g = j_gae(d["rewards"], d["values"], d["bootstrap"],
                           d["done"], 0.9, tau)
    ret, gae = gae_returns(*(torch.from_numpy(d[k]) for k in
                             ("rewards", "values", "bootstrap", "done")),
                           0.9, tau)
    np.testing.assert_allclose(ret.numpy(), np.asarray(want_r), **TOL)
    np.testing.assert_allclose(gae.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("mode", [0, 1, -1])
def test_dueling_loss_and_grads_match_jax(mode):
    d = _traj(2 + mode)

    def jax_mean_loss(values, log_probs, entropies):
        stats = jax.vmap(
            lambda r, v, b, lp, e, dn: j_loss(r, v, b, lp, e, dn, None,
                                              jnp.int32(mode), 0.9, 1.0, 0.01,
                                              0.2, False),
            in_axes=(1, 1, 0, 1, 1, 1))(d["rewards"], values, d["bootstrap"],
                                        log_probs, entropies, d["done"])
        return stats.loss.mean(), stats

    (want, wstats), wgrads = jax.value_and_grad(
        jax_mean_loss, argnums=(0, 1, 2), has_aux=True)(
            d["values"], d["log_probs"], d["entropies"])
    leaves = {k: torch.from_numpy(d[k]).requires_grad_()
              for k in ("values", "log_probs", "entropies")}
    stats = dueling_loss(torch.from_numpy(d["rewards"]), leaves["values"],
                         torch.from_numpy(d["bootstrap"]), leaves["log_probs"],
                         leaves["entropies"], torch.from_numpy(d["done"]),
                         mode, 0.9, 1.0, 0.01, 0.2)
    loss = stats.loss.mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for name in ("policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(getattr(stats, name).detach().numpy(),
                                   np.asarray(getattr(wstats, name)), **TOL,
                                   err_msg=name)
    for k, wg in zip(("values", "log_probs", "entropies"), wgrads):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(wg),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("mode", [0, 1, -1, 2])
@pytest.mark.parametrize("aux", [True, False])
def test_aux_pred_loss_and_grads_match_jax(mode, aux):
    """The TAT aux head's L1 loss, sum_t |r_pred - r_tracker| per row: in
    the stats always (with aux), in the loss at every mode but 0; the
    gradient reaches r_pred only where it enters. Without aux no r_pred
    goes in and pred_loss is zero."""
    d = _traj(7 + mode)
    r_pred = np.random.RandomState(11 + mode).randn(T, B).astype(np.float32)

    def jax_mean_loss(values, log_probs, r_preds):
        stats = jax.vmap(
            lambda r, v, b, lp, e, dn, rp: j_loss(
                r, v, b, lp, e, dn, rp if aux else None, jnp.int32(mode),
                0.9, 1.0, 0.01, 0.2, aux),
            in_axes=(1, 1, 0, 1, 1, 1, 1))(
                d["rewards"], values, d["bootstrap"], log_probs,
                d["entropies"], d["done"], r_preds)
        return stats.loss.mean(), stats

    (want, wstats), wgrads = jax.value_and_grad(
        jax_mean_loss, argnums=(0, 1, 2), has_aux=True)(
            d["values"], d["log_probs"], r_pred)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in
              (("values", d["values"]), ("log_probs", d["log_probs"]),
               ("r_pred", r_pred))}
    stats = dueling_loss(torch.from_numpy(d["rewards"]), leaves["values"],
                         torch.from_numpy(d["bootstrap"]), leaves["log_probs"],
                         torch.from_numpy(d["entropies"]),
                         torch.from_numpy(d["done"]), mode, 0.9, 1.0, 0.01,
                         0.2, leaves["r_pred"] if aux else None)
    loss = stats.loss.mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    np.testing.assert_allclose(stats.loss.detach().numpy(),
                               np.asarray(wstats.loss), **TOL)
    np.testing.assert_allclose(stats.pred_loss.detach().numpy(),
                               np.asarray(wstats.pred_loss), **TOL)
    assert bool((stats.pred_loss > 0).all()) == aux
    for k, wg in zip(("values", "log_probs", "r_pred"), wgrads):
        got = leaves[k].grad
        if got is None:          # r_pred outside the loss: JAX's grad is 0
            assert not np.asarray(wg).any(), k
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(wg), **TOL,
                                   err_msg=k)
    assert (leaves["r_pred"].grad is not None) == (aux and mode != 0)


@pytest.mark.parametrize("scale", [1e-2, 1e3])   # below and above the clip
def test_shared_adam_with_clip_matches_optax_chain(scale):
    rng = np.random.RandomState(3)
    shapes = [(7, 3), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    opt = j_make_opt("Adam", 1e-3, 50.0)
    state = opt.init(params)
    tparams = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    topt = SharedAdam(tparams, lr=1e-3, grad_clip=50.0)
    for step in range(5):
        grads = [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g.copy())
        topt.step()
        for p, w in zip(tparams, params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       **TOL, err_msg=f"step {step}")


def test_clip_by_global_norm_matches_optax():
    rng = np.random.RandomState(4)
    grads = [rng.randn(6, 4).astype(np.float32) * 40,
             rng.randn(9).astype(np.float32) * 40]
    clip = optax.clip_by_global_norm(50.0)
    want, _ = clip.update(grads, clip.init(grads))
    got = [torch.from_numpy(g.copy()) for g in grads]
    np.testing.assert_allclose(global_norm(got).item(),
                               float(optax.global_norm(grads)), **TOL)
    clip_by_global_norm_(got, 50.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("train_mode", [0, 1, -1])
def test_train_mode_masking_matches_jax(train_mode):
    """Mode 0 updates only player0, mode 1 only player1 (and the clip norm
    sees only them); the frozen player does not move."""
    jm = jbuild(JNetConfig.from_name("maze-lstm", aux="none"), 4, (13, 13))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    jt = JTrainConfig(train_mode=train_mode)
    opt = j_opt_for(JNetConfig.from_name("maze-lstm", aux="none"), jt, params)
    rng = np.random.RandomState(5)
    grads = jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * 0.5).astype(np.float32), params)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = params_from_flax(optax.apply_updates(params, updates))

    tm = build_model(NetConfig.from_name("maze-lstm", aux="none"), 4, (13, 13),
                     device="cpu")
    tm.load_state_dict(params_from_flax(params))
    tgrads = params_from_flax(grads)
    for name, p in tm.named_parameters():
        p.grad = tgrads[name].clone()
    make_optimizer_for(tm, TrainConfig(train_mode=train_mode)).step()
    before = params_from_flax(params)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   **TOL, err_msg=name)
        frozen = f"player{1 - train_mode}." if train_mode in (0, 1) else None
        if frozen and name.startswith(frozen):
            assert torch.equal(p.detach(), before[name]), name
