"""The port's model (active_tracking_rl_torch/models/) against the flax
modules of the JAX package, on params converted by ``params_from_flax``.

Tolerance: float32 forwards agree to rtol 1e-5 / atol 1e-5. Both sides run in
float32 on the CPU; only the summation order of the conv and matmul
reductions differs (XLA vs PyTorch's CPU kernels), which moves results by a
few ulp (~1e-7 relative) per layer. Sampled actions are compared exactly:
both take argmax(logits + the same Gumbel noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.models.encoders import CNNMaze as JCNNMaze
from active_tracking_rl_tpu.models.heads import eval_discrete as j_eval
from active_tracking_rl_tpu.models.recurrent import LSTMCell as JLSTMCell
from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.models.dueling import build_model, params_from_flax
from active_tracking_rl_torch.models.heads import eval_discrete, sample_discrete
from active_tracking_rl_torch.ops.noise import Threefry

TOL = dict(rtol=1e-5, atol=1e-5)
B = 8


def _obs(rng, b, k=1):
    return rng.randint(0, 5, size=(b, k, 13, 13, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = jbuild(JNetConfig.from_name("maze-lstm", aux="none"), 4, (13, 13))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(NetConfig.from_name("maze-lstm", aux="none"), 4, (13, 13),
                     device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def test_converter_covers_every_parameter(models):
    _, params, tm = models
    sd = params_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("stack", [1, 2])
def test_cnn_maze_matches_flax(stack):
    rng = np.random.RandomState(stack)
    x = _obs(rng, B, stack)
    enc = JCNNMaze()
    p = enc.init(jax.random.PRNGKey(stack), x)["params"]
    want = np.asarray(enc.apply({"params": p}, x))
    tm = build_model(NetConfig.from_name("maze-lstm", stack_frames=stack),
                     4, (13, 13), device="cpu")
    # reuse the converter on a one-player tree holding just this encoder
    tree = {"CNNMaze_0": p, "LSTMCell_0": _zero_lstm(256, 128),
            "ValueNet_0": {"Dense_0": _zero_dense(128, 1)},
            "PolicyNet_0": {"Dense_0": _zero_dense(128, 4)}}
    tm.player0.load_state_dict({k[len("player0."):]: v for k, v in
                                params_from_flax({"player0": tree}).items()})
    got = tm.player0.encoder(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _zero_lstm(i, h):
    return {"w_ih": np.zeros((i, 4 * h), np.float32),
            "w_hh": np.zeros((h, 4 * h), np.float32),
            "b_ih": np.zeros(4 * h, np.float32),
            "b_hh": np.zeros(4 * h, np.float32)}


def _zero_dense(i, o):
    return {"kernel": np.zeros((i, o), np.float32), "bias": np.zeros(o, np.float32)}


def test_lstm_cell_matches_flax(models):
    _, params, tm = models
    rng = np.random.RandomState(0)
    x = rng.randn(B, 256).astype(np.float32)
    h = rng.randn(B, 128).astype(np.float32)
    c = rng.randn(B, 128).astype(np.float32)
    p = dict(params["player0"]["LSTMCell_0"])
    p["b_ih"] = rng.randn(512).astype(np.float32)     # non-zero biases too
    p["b_hh"] = rng.randn(512).astype(np.float32)
    wh, wc = JLSTMCell(128).apply({"params": p}, x, h, c)
    cell = tm.player0.lstm
    with torch.no_grad():
        cell.bias_ih.copy_(torch.from_numpy(p["b_ih"]))
        cell.bias_hh.copy_(torch.from_numpy(p["b_hh"]))
        gh, gc = cell(*map(torch.from_numpy, (x, h, c)))
        cell.bias_ih.zero_()
        cell.bias_hh.zero_()
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)


def test_step_both_matches_jax(models):
    jm, params, tm = models
    rng = np.random.RandomState(1)
    obs = rng.randint(0, 5, size=(B, 2, 1, 13, 13, 1)).astype(np.float32)
    hx = rng.randn(B, 2, 128).astype(np.float32)
    cx = rng.randn(B, 2, 128).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, o, h, c, k: jm.step_both(p, o, h, c, k))(
        params, obs, hx, cx, key)
    # step_both splits its key into the tracker's and the target's
    k0, k1 = jax.random.split(key)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (B, 4)))
                       for k in (k0, k1)], axis=1)
    with torch.no_grad():
        got = tm.step_both(*map(torch.from_numpy, (obs, hx, cx, gumbel)))
    names = ["values", "actions", "entropies", "log_probs", "hx", "cx"]
    # the seventh value, r_pred, is None in both: no TAT aux head
    assert len(got) == len(want) == 7 and got[6] is None and want[6] is None
    for name, g, w in zip(names, got, want[:6]):
        if name == "actions":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)


def test_sample_and_eval_discrete():
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(64, 4).astype(np.float32) * 3)
    g = torch.from_numpy(rng.gumbel(size=(64, 4)).astype(np.float32))
    s = sample_discrete(logits, g)
    assert torch.equal(s.action, torch.argmax(logits + g, -1))
    greedy = sample_discrete(logits, g, test=True)
    assert torch.equal(greedy.action, torch.argmax(logits, -1))
    ent, logp = eval_discrete(logits, s.action)
    torch.testing.assert_close(ent, s.entropy)
    torch.testing.assert_close(logp, s.log_prob)
    we, wl = j_eval(jnp.asarray(logits.numpy()), jnp.asarray(s.action.numpy()))
    np.testing.assert_allclose(ent.numpy(), np.asarray(we), **TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(wl), **TOL)


def test_init_matches_reference_bounds():
    """U(-b, b) with b = sqrt(6 / (fan_in + fan_out)) for conv/fc, torch's
    1/sqrt(H) for the LSTM, zero biases: the same bounds as the JAX init."""
    tm = build_model(NetConfig.from_name("maze-lstm", aux="none"), 4, (13, 13),
                     device="cpu", generator=Threefry().manual_seed(0))
    bounds = {"encoder.conv0.weight": np.sqrt(6 / (9 + 9 * 16)),
              "encoder.conv1.weight": np.sqrt(6 / (16 * 9 + 9 * 32)),
              "encoder.fc.weight": np.sqrt(6 / (512 + 256)),
              "lstm.weight_ih": 1 / np.sqrt(128),
              "lstm.weight_hh": 1 / np.sqrt(128),
              "value.weight": np.sqrt(6 / (128 + 1)),
              "policy.weight": np.sqrt(6 / (128 + 4))}
    for name, p in tm.player0.named_parameters():
        if name in bounds:
            b = bounds[name]
            assert p.abs().max() <= b and p.abs().max() > 0.8 * b, name
        else:
            assert torch.count_nonzero(p) == 0, name
