"""CNNSimple's backward pass: the encoder's parameter gradients of a fixed
random projection of its features, (B, 1, 82, 82, 1) inputs.

* Tie-free inputs (standard normal cells, so no two conv outputs in a
  max-pool window are equal): the port's float32 gradients against
  ``jax.grad`` of the flax module on the same parameters.
* Map inputs (Full observations of Track2D-BlockFullNav-v0 from the port's
  env, cells in {0, 1, 2, 4}, with uniform regions whose conv outputs tie
  inside a pool window): the port's float32 gradients against its own
  float64 run. A window whose two largest outputs differ in float64 by
  less than float32's rounding (a near-tie: one, 2.7e-8 apart, in the third
  pool of these inputs) may pick another cell in each precision and route
  that window's gradient elsewhere, which no backward could match: where
  the float32 run picked another cell of such a window, the float64 run
  takes the float32 run's; every other window keeps its own pick, and at
  most MAX_NEAR_TIES windows may be near-ties picked apart. The JAX package is not the reference here: on ties XLA's max-pool
  backward may route a gradient to another of the equal cells, which is
  reference behaviour the port does not copy (ROADMAP, faults).

Tolerance: each gradient tensor's largest difference within 2e-5 of its
largest entry. Every conv weight gradient sums one product per input cell
and row (16 x 82 x 82 = 107,584 terms for conv0), so float32 rounding
alone reaches a few 1e-6 of the scale; per-element tolerances do not
apply to entries that are sums near zero.
"""

from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.models.encoders import CNNSimple as JCNNSimple
from active_tracking_rl_torch.config import parse_env_id
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models import encoders
from active_tracking_rl_torch.models.dueling import params_from_flax
from active_tracking_rl_torch.models.encoders import CNNSimple
from active_tracking_rl_torch.ops.noise import Threefry

HW, B = (82, 82), 16
SCALE_TOL = 2e-5
#: a pool window's two largest float64 outputs closer than this share of
#: the pool input's largest |value| are a tie of float32 rounding (the
#: convs sum up to 800 products, whose float32 rounding reaches ~800 eps
#: of their magnitudes at worst); at most MAX_NEAR_TIES such windows may be
#: picked apart by the two precisions
NEAR_TIE, MAX_NEAR_TIES = 1e-5, 2


def _params(x):
    return jax.tree_util.tree_map(
        np.asarray, JCNNSimple().init(jax.random.PRNGKey(0), x)["params"])


def _projection(x, params):
    out = JCNNSimple().apply({"params": params}, x)
    return np.random.RandomState(1).randn(*out.shape).astype(np.float32)


def _port_grads(x, params, w, dtype, choices=None):
    """The encoder's parameter gradients, the cells its max-pools took, and
    the count of near-tie windows where they took `choices`' cells (another
    run's picks; NEAR_TIE) in place of their own."""
    enc = CNNSimple(HW, 1)
    sd = params_from_flax({"p": {"CNNSimple_0": params}})
    enc.load_state_dict({k[len("p.encoder."):]: v for k, v in sd.items()})
    enc = enc.to(dtype)
    took, near_ties = [], [0]

    def max_pool2d(h, k):
        out, idx = F.max_pool2d(h, k, return_indices=True)
        if choices is not None:
            other = choices[len(took)]
            n, c, oh, ow = out.shape
            win = (h[:, :, :oh * k, :ow * k].detach()
                   .reshape(n, c, oh, k, ow, k).transpose(3, 4)
                   .reshape(n, c, oh, ow, k * k))
            top = win.topk(2, -1).values
            tie = (top[..., 0] - top[..., 1]
                   <= NEAR_TIE * h.detach().abs().max())
            swap = tie & (other != idx)
            near_ties[0] += int(swap.sum())
            idx = torch.where(swap, other, idx)
            out = h.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        took.append(idx)
        return out

    with mock.patch.object(encoders, "F", SimpleNamespace(
            **{**vars(F), "max_pool2d": max_pool2d})):
        (enc(torch.from_numpy(x).to(dtype))
         * torch.from_numpy(w).to(dtype)).sum().backward()
    return ({n: p.grad.to(torch.float64) for n, p in enc.named_parameters()},
            took, near_ties[0])


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
    _assert_close_to_scale(_port_grads(x, params, w, torch.float32)[0], want)


def test_backward_matches_float64_on_map_inputs():
    env = TrackEnv(parse_env_id("Track2D-BlockFullNav-v0"), "cpu")
    _, obs = env.reset_batch(B, Threefry().manual_seed(0))
    x = obs[:, 0, None, ..., None].to(torch.float32).numpy()
    assert set(np.unique(x)) <= {0.0, 1.0, 2.0, 4.0} and x.shape == (
        B, 1, *HW, 1)
    params = _params(x)
    w = _projection(x, params)
    got, took, _ = _port_grads(x, params, w, torch.float32)
    want, _, near_ties = _port_grads(x, params, w, torch.float64, took)
    assert near_ties <= MAX_NEAR_TIES, near_ties
    _assert_close_to_scale(got, want)
