"""CNNSimple's backward pass: the encoder's parameter gradients of a fixed
random projection of its features, (B, 1, 82, 82, 1) inputs.

* Tie-free inputs (standard normal cells, so no two conv outputs in a
  max-pool window are equal): the port's float32 gradients against
  ``jax.grad`` of the flax module on the same parameters.
* Map inputs (Full observations of Track2D-BlockFullNav-v0 from the port's
  env, cells in {0, 1, 2, 4}, with uniform regions whose conv outputs tie
  inside a pool window): the port's float32 gradients against its own
  float64 run. The JAX package is not the reference here: on ties XLA's
  max-pool backward may route a gradient to another of the equal cells,
  which is reference behaviour the port does not copy (ROADMAP, faults).

Tolerance: each gradient tensor's largest difference within 2e-5 of its
largest entry. Every conv weight gradient sums one product per input cell
and row (16 x 82 x 82 = 107,584 terms for conv0), so float32 rounding
alone reaches a few 1e-6 of the scale; per-element tolerances do not
apply to entries that are sums near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.models.encoders import CNNSimple as JCNNSimple
from active_tracking_rl_torch.config import parse_env_id
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import params_from_flax
from active_tracking_rl_torch.models.encoders import CNNSimple

HW, B = (82, 82), 16
SCALE_TOL = 2e-5


def _params(x):
    return jax.tree_util.tree_map(
        np.asarray, JCNNSimple().init(jax.random.PRNGKey(0), x)["params"])


def _projection(x, params):
    out = JCNNSimple().apply({"params": params}, x)
    return np.random.RandomState(1).randn(*out.shape).astype(np.float32)


def _port_grads(x, params, w, dtype):
    enc = CNNSimple(HW, 1)
    sd = params_from_flax({"p": {"CNNSimple_0": params}})
    enc.load_state_dict({k[len("p.encoder."):]: v for k, v in sd.items()})
    enc = enc.to(dtype)
    (enc(torch.from_numpy(x).to(dtype))
     * torch.from_numpy(w).to(dtype)).sum().backward()
    return {n: p.grad.to(torch.float64) for n, p in enc.named_parameters()}


def _assert_close_to_scale(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        scale = w.abs().max().item()
        err = (got[name] - w).abs().max().item()
        assert scale > 0 and err <= SCALE_TOL * scale, (name, err, scale)


def test_backward_matches_jax_on_tie_free_inputs():
    x = np.random.RandomState(0).randn(B, 1, *HW, 1).astype(np.float32)
    params = _params(x)
    w = _projection(x, params)
    jgrads = jax.grad(lambda p: jnp.sum(
        JCNNSimple().apply({"params": p}, x) * w))(params)
    want = params_from_flax({"p": {"CNNSimple_0": jax.tree_util.tree_map(
        np.asarray, jgrads)}})
    want = {k[len("p.encoder."):]: v.to(torch.float64)
            for k, v in want.items()}
    _assert_close_to_scale(_port_grads(x, params, w, torch.float32), want)


def test_backward_matches_float64_on_map_inputs():
    env = TrackEnv(parse_env_id("Track2D-BlockFullNav-v0"), "cpu")
    _, obs = env.reset_batch(B, torch.Generator().manual_seed(0))
    x = obs[:, 0, None, ..., None].to(torch.float32).numpy()
    assert set(np.unique(x)) <= {0.0, 1.0, 2.0, 4.0} and x.shape == (
        B, 1, *HW, 1)
    params = _params(x)
    w = _projection(x, params)
    _assert_close_to_scale(_port_grads(x, params, w, torch.float32),
                           _port_grads(x, params, w, torch.float64))
