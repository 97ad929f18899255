"""The bf16 model and train step of the port against the JAX package's bf16.

With ``NetConfig.bf16`` both packages compute the encoder in bfloat16 and
the cell's two matmuls with bfloat16 inputs; parameters, heads and the
recurrent state stay float32. The encoder follows flax's ``dtype``: each
conv and the fc take bfloat16 inputs, weights and biases, the bias adds,
pools and relus stay bfloat16, and only the features are cast back to
float32 (``active_tracking_rl_tpu/models/encoders.py:22-27,58-65``; the
port's ``models/encoders.py:_conv``, ``_fc`` and
``_StackedConvEncoder.forward``). The cells cast their matmul results back
to float32 (``active_tracking_rl_tpu/models/recurrent.py:19-25``; the
port's ``models/recurrent.py:matmul``). A backward rounds a cotangent to
bfloat16 where its forward cast a bfloat16 result to float32, so both
packages round cotangents at the same places: the encoder's output and
each cell matmul's output.

Two effects set the tolerances, one bfloat16 step being a relative 2^-8
to 2^-7 of a value:
- Accumulation order. Each backend sums a bfloat16 matmul or conv in its
  own order in float32; where that sum lies next to a rounding boundary,
  its bfloat16 result can differ by one step. Such a flip is rare: at the
  sizes below three of the four networks agree to 4e-7 of each tensor's
  scale, and tat-maze-lstm shows isolated elements (max 1.4e-3 of scale
  on outputs and 4.4e-3 on gradients when this test was written).
- XLA's bias gradients. A bfloat16 layer's bias gradient is its bfloat16
  cotangent summed over every position. XLA on the CPU lands up to 6.7e-2
  of scale from that sum taken in float32 (tat-maze-lstm's player-1 conv0
  in the vjp test below; 9.4e-3 on conv0 in the train step, when this
  test was written), the port within one bfloat16 step of it.
  ``float32_bias_sums`` has the JAX package take that sum in float32
  instead and leaves every other value alone (its forward and every other
  gradient are checked bit for bit in the vjp test), so each bias
  gradient is held to the sum of JAX's own cotangent.

``test_bf16_model_vjp_matches_jax`` runs one greedy forward of the whole
model and its vjp for a fixed random cotangent, from JAX's initial
parameters with every bias (zero at init) set to random values, so that
the bias adds' roundings show: greedy actions equal; values, entropies,
log-probabilities, states and the aux prediction to 2^-8 of each output's
scale; every gradient to 2^-7 of its tensor's scale (one flipped step)
against the JAX gradient with float32 bias sums.

``test_bf16_train_step_matches_jax`` runs one train step of tat-maze-lstm
at train mode -1 on ``Track2D-BlockPartialPZR-v0`` and one of maze-lstm at
mode 0 on ``Track2D-BlockPartialNav-v0`` (tests/torch_learner_pair.py at
B = P = T = 8) from the same parameters, pool and noise:
- env state, frame stack, pool pointer and episode lengths bit for bit:
  every sampled action equal (no near-tie flipped one at this seed);
- loss and metrics to rtol 1e-4 / atol 1e-5 (GRAD_TOL; measured at most
  1.6e-5 relative): at init every bias is zero, so the forwards round the
  same values;
- gradients to 2^-7 of each tensor's scale against the JAX step with
  float32 bias sums (measured at most 3.1e-3), and the encoder's bias
  gradients also to XLA's own at 2^-5 (measured at most 9.4e-3);
- the updated float32 parameters to atol 1e-4, a tenth of lr: a first
  SharedAdam step moves a parameter by about lr x g / (|g| + eps), so the
  gradients' differences show only where |g| is near eps (measured at
  most 2.2e-5).
"""

import contextlib
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_torch.config import NetConfig, parse_env_id
from active_tracking_rl_torch.models.dueling import build_model, params_from_flax
from tests.torch_draws import assert_state_equal
from tests.torch_learner_pair import GRAD_TOL, run_steps

ONE_STEP = 2.0 ** -7
XLA_BIAS = 2.0 ** -5
N = 6


@contextlib.contextmanager
def float32_bias_sums():
    """Within, every bfloat16 flax Conv and Dense computes without its bias
    and then adds it as bfloat16(float32(y) + float32(bfloat16(b))): the
    value of flax's bfloat16 add, with the bias gradient summed in float32
    and rounded once to bfloat16. Yields the list of layers it changed."""
    layers = []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if (context.method_name != "__call__"
                or not isinstance(mod, (nn.Conv, nn.Dense))
                or mod.dtype != jnp.bfloat16 or mod.is_initializing()):
            return next_fun(*args, **kwargs)
        layers.append(mod.path)
        object.__setattr__(mod, "use_bias", False)
        try:
            y = next_fun(*args, **kwargs)
        finally:
            object.__setattr__(mod, "use_bias", True)
        b = mod.variables["params"]["bias"].astype(jnp.bfloat16)
        return (y.astype(jnp.float32) + b.astype(jnp.float32)).astype(
            jnp.bfloat16)

    with nn.intercept_methods(interceptor):
        yield layers


def _encoder_biases(names):
    return {n for n in names if ".encoder." in n and n.endswith(".bias")}


def _scaled_close(got, want, frac, what):
    """|got - want| <= frac * max|want|, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= frac * scale, f"{what}: {err:.3e} > {frac:.3e} x {scale:.3e}"


def _random_biases(params, rng):
    """Every 1-D leaf (the biases) set to N(0, 0.1^2)."""
    return jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), params)


@pytest.mark.parametrize("name,env_id", [
    ("tat-maze-lstm", "Track2D-BlockPartialPZR-v0"),
    ("maze-gru", "Track2D-BlockPartialNav-v0"),
    ("icml-lstm", "Track2D-EmptyPartialPZR-v0"),
    ("tat-icml-gru", "Track2D-BlockPartialPZR-v0")])
def test_bf16_model_vjp_matches_jax(name, env_id):
    ecfg = parse_env_id(env_id)
    rng = np.random.RandomState(5)
    jn = dataclasses.replace(JNetConfig.from_name(name), bf16=True)
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    params = _random_biases(jm.init(jax.random.PRNGKey(3)), rng)
    obs = rng.uniform(0.0, 6.0, (N, 2, 1) + ecfg.obs_shape + (1,)).astype(
        np.float32)
    hx, cx = (0.3 * rng.standard_normal((2, N, 2, 128))).astype(np.float32)
    # cotangents of values, entropies, log-probs, h, c and the aux prediction
    shapes = {0: (N, 2), 2: (N, 2), 3: (N, 2), 4: (N, 2, 128),
              5: (N, 2, 128), 6: (N, 1)}
    cts = {i: rng.standard_normal(s).astype(np.float32)
           for i, s in shapes.items()}

    def jfwd(p):
        out = jm.step_both(p, jnp.asarray(obs), hx, cx,
                           jax.random.PRNGKey(0), test=True)
        loss = sum(jnp.sum(out[i] * ct) for i, ct in cts.items()
                   if out[i] is not None)
        return loss, out

    def jvjp():
        (_, out), grads = jax.value_and_grad(jfwd, has_aux=True)(params)
        return out, params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                            grads))

    want, xla_grads = jvjp()
    with float32_bias_sums() as layers:
        want32, jgrads = jvjp()
    # the encoder's convs and fc, once per player
    assert len(layers) == 6 and len(set(layers)) == 3
    for i in range(len(want)):
        assert (want32[i] is None) == (want[i] is None)
        if want[i] is not None:
            np.testing.assert_array_equal(np.asarray(want32[i]),
                                          np.asarray(want[i]))
    biases = _encoder_biases(jgrads)
    assert len(biases) == 6
    for pname in set(jgrads) - biases:
        np.testing.assert_array_equal(jgrads[pname].numpy(),
                                      xla_grads[pname].numpy(), pname)

    tn = dataclasses.replace(NetConfig.from_name(name), bf16=True)
    tm = build_model(tn, ecfg.num_actions, ecfg.obs_shape, device="cpu")
    tm.load_state_dict(params_from_flax(params))
    got = tm.step_both(*map(torch.from_numpy, (obs, hx, cx)), None,
                       test=True)
    sum(torch.sum(got[i] * torch.from_numpy(ct)) for i, ct in cts.items()
        if got[i] is not None).backward()

    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for i in cts:
        assert (got[i] is None) == (want[i] is None)
        if got[i] is not None:
            _scaled_close(got[i].detach().numpy(), want[i], 2.0 ** -8,
                          f"output {i}")
    assert set(jgrads) == {n for n, _ in tm.named_parameters()}
    for pname, p in tm.named_parameters():
        _scaled_close(p.grad.numpy(), jgrads[pname].numpy(), ONE_STEP, pname)


@pytest.mark.parametrize("network,env_id,mode", [
    ("tat-maze-lstm", "Track2D-BlockPartialPZR-v0", -1),
    ("maze-lstm", "Track2D-BlockPartialNav-v0", 0)])
def test_bf16_train_step_matches_jax(network, env_id, mode):
    res = run_steps(env_id, network, (mode,), train_mode=mode, bf16=True)[0]
    with float32_bias_sums() as layers:
        res32 = run_steps(env_id, network, (mode,), train_mode=mode,
                          bf16=True)[0]
    assert len(set(layers)) == 3
    p1, xla_grads, c1, m1, ptr1 = res["jax"]
    tp1, tgrads, tc1, tm1, tptr1 = res["torch"]
    assert_state_equal(tc1.env_state, c1.env_state)
    np.testing.assert_array_equal(tc1.obs_stack.numpy(),
                                  np.asarray(c1.obs_stack))
    assert int(tptr1) == int(ptr1)
    np.testing.assert_array_equal(tm1.ep_len.numpy(), np.asarray(m1.ep_len))
    for name in ("loss", "policy_loss", "value_loss", "entropy", "ep_return",
                 "pred_loss", "grad_norm"):
        np.testing.assert_allclose(getattr(tm1, name).numpy(),
                                   np.asarray(getattr(m1, name)), **GRAD_TOL,
                                   err_msg=name)
    want = params_from_flax(res32["jax"][1])
    xla = params_from_flax(xla_grads)
    assert set(want) == set(tgrads) == set(xla)
    biases = _encoder_biases(want)
    assert len(biases) == 6
    for name, g in want.items():
        _scaled_close(tgrads[name].numpy(), g.numpy(), ONE_STEP, name)
        if name in biases:
            _scaled_close(tgrads[name].numpy(), xla[name].numpy(), XLA_BIAS,
                          name + " (XLA's sum)")
    for name, w in params_from_flax(p1).items():
        np.testing.assert_allclose(tp1[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
