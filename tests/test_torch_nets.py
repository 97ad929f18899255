"""Every discrete network of the port (active_tracking_rl_torch/models/)
against the flax modules of the JAX package, on params converted by
``params_from_flax``: GRUCell, the ICML and CNNSimple encoders, and
``DuelingModel.step_both`` for each encoder x {lstm, gru, none} with a TAT
target (so both A3CPlayer and TATPlayer run), greedy and sampled.

Tolerance: float32 forwards agree to rtol 1e-5 / atol 1e-5, as in
tests/test_torch_models.py: both sides run float32 on the CPU and only the
summation order of the conv and matmul reductions differs. Actions are
compared exactly (argmax of the same logits, plus the same Gumbel noise
when sampled). The converters are exact: ``params_to_flax`` of
``params_from_flax`` gives the flax tree back bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.models.encoders import ICML as JICML
from active_tracking_rl_tpu.models.encoders import CNNSimple as JCNNSimple
from active_tracking_rl_tpu.models.recurrent import GRUCell as JGRUCell
from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.models.dueling import (build_model,
                                                     params_from_flax,
                                                     params_to_flax)
from active_tracking_rl_torch.models.encoders import ICML, CNNSimple
from active_tracking_rl_torch.models.recurrent import GRUCell

TOL = dict(rtol=1e-5, atol=1e-5)
B = 6
PARTIAL, FULL = (13, 13), (82, 82)
NAMES = [f"tat-{enc}{rnn}" for enc in ("maze", "icml", "cnn")
         for rnn in ("-lstm", "-gru", "")]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _obs(rng, shape, b=B, agents=None, k=1):
    lead = (b,) if agents is None else (b, agents)
    return rng.randint(0, 5, size=lead + (k,) + shape + (1,)).astype(np.float32)


def _hw(name):
    """CNNSimple on Full obs: a 13 x 13 window leaves it no cell."""
    return FULL if "cnn" in name else PARTIAL


def _both(name, seed=0, hw=None):
    hw = hw or _hw(name)
    jm = jbuild(JNetConfig.from_name(name), 4, hw)
    params = _np(jm.init(jax.random.PRNGKey(seed)))
    tm = build_model(NetConfig.from_name(name), 4, hw, device="cpu")
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


def test_gru_cell_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(B, 256).astype(np.float32)
    h = rng.randn(B, 128).astype(np.float32)
    c = rng.randn(B, 128).astype(np.float32)
    cell = JGRUCell(128)
    p = _np(cell.init(jax.random.PRNGKey(0), x, h, c)["params"])
    p = dict(p, b_ih=rng.randn(384).astype(np.float32),   # non-zero biases
             b_hh=rng.randn(384).astype(np.float32))
    wh, wc = cell.apply({"params": p}, x, h, c)
    tc = GRUCell(256, 128)
    tc.load_state_dict({"weight_ih": torch.from_numpy(p["w_ih"].T.copy()),
                        "weight_hh": torch.from_numpy(p["w_hh"].T.copy()),
                        "bias_ih": torch.from_numpy(p["b_ih"]),
                        "bias_hh": torch.from_numpy(p["b_hh"])})
    with torch.no_grad():
        gh, gc = tc(*map(torch.from_numpy, (x, h, c)))
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)
    np.testing.assert_array_equal(gc.numpy(), c)   # c passes through


@pytest.mark.parametrize("enc,hw,stack", [
    ("icml", PARTIAL, 1), ("icml", FULL, 2), ("cnn", FULL, 1),
    ("cnn", FULL, 2), ("cnn", PARTIAL, 1)])
def test_encoder_matches_flax(enc, hw, stack):
    rng = np.random.RandomState(stack)
    x = _obs(rng, hw, k=stack)
    jenc = JICML() if enc == "icml" else JCNNSimple()
    p = _np(jenc.init(jax.random.PRNGKey(stack), x)["params"])
    want = np.asarray(jenc.apply({"params": p}, x))
    tenc = (ICML if enc == "icml" else CNNSimple)(hw, stack)
    # the converter on a one-player tree holding just this encoder
    flax_name = "ICML_0" if enc == "icml" else "CNNSimple_0"
    sd = params_from_flax({"p": {flax_name: p}})
    tenc.load_state_dict({k[len("p.encoder."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert tenc.out_dim == want.shape[1]
    np.testing.assert_allclose(got, want, **TOL)


def test_cnn_simple_on_a_partial_window_has_no_features():
    """CNNSimple's third pool leaves a 13 x 13 window nothing: the JAX
    module returns (B, 0) features, and so does the port; the cell then
    sees only its recurrent input."""
    jm, params, tm = _both("tat-cnn-lstm", hw=PARTIAL)
    assert params["player0"]["LSTMCell_0"]["w_ih"].shape == (0, 512)
    assert tm.player0.encoder.out_dim == 0
    rng = np.random.RandomState(3)
    obs = _obs(rng, PARTIAL, agents=2)
    hx = rng.randn(B, 2, 128).astype(np.float32)
    want = jm.step_both(params, obs, hx, hx, jax.random.PRNGKey(0), test=True)
    with torch.no_grad():
        got = tm.step_both(*map(torch.from_numpy, (obs, hx, hx)), None,
                           test=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_converters_cover_every_parameter_and_invert(name):
    _, params, tm = _both(name)
    sd = params_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    assert all(tm.state_dict()[k].shape == v.shape for k, v in sd.items())
    _assert_tree_equal(params_to_flax(sd, NetConfig.from_name(name)), params)
    _assert_tree_equal(params_to_flax(tm.state_dict(),
                                      NetConfig.from_name(name)), params)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_step_both_matches_jax(name):
    jm, params, tm = _both(name, seed=1)
    rng = np.random.RandomState(4)
    obs = _obs(rng, _hw(name), agents=2)
    hx = rng.randn(B, 2, 128).astype(np.float32)
    cx = rng.randn(B, 2, 128).astype(np.float32)
    want = jax.jit(lambda p, o, h, c: jm.step_both(
        p, o, h, c, jax.random.PRNGKey(0), test=True))(params, obs, hx, cx)
    with torch.no_grad():
        got = tm.step_both(*map(torch.from_numpy, (obs, hx, cx)), None,
                           test=True)
    _assert_step_close(got, want)


@pytest.mark.parametrize("name", ["maze-gru", "tat-icml-lstm"])
def test_sampled_step_both_matches_jax(name):
    jm, params, tm = _both(name, seed=2)
    rng = np.random.RandomState(5)
    obs = _obs(rng, _hw(name), agents=2)
    hx = rng.randn(B, 2, 128).astype(np.float32)
    cx = rng.randn(B, 2, 128).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, o, h, c, k: jm.step_both(p, o, h, c, k))(
        params, obs, hx, cx, key)
    # step_both splits its key into the tracker's and the target's
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (B, 4)))
                       for k in jax.random.split(key)], axis=1)
    with torch.no_grad():
        got = tm.step_both(*map(torch.from_numpy, (obs, hx, cx, gumbel)))
    _assert_step_close(got, want)


def _assert_step_close(got, want):
    names = ["values", "actions", "entropies", "log_probs", "hx", "cx",
             "r_pred"]
    assert len(got) == len(want) == 7
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
        elif name == "actions":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)


def test_continuous_names_still_raise():
    """A continuous network builds (tests/test_torch_continuous.py holds it
    to flax) but the Track2D learner, whose actions are discrete, refuses
    it and names the host-env trainer."""
    from active_tracking_rl_torch.config import TrainConfig
    from active_tracking_rl_torch.rl.learner import make_train_step
    ncfg = NetConfig.from_name("tat-maze-lstm-continuous")
    model = build_model(ncfg, 4, PARTIAL, device="cpu")
    assert model.player0.sigma is not None
    with pytest.raises(ValueError, match="host_loop"):
        make_train_step(model, None, ncfg, TrainConfig(), None)
