"""The port's SharedAdam (active_tracking_rl_torch/rl/optim.py) against the
JAX package's optimizer (rl/optim.py, rl/learner.py:make_optimizer_for),
step by step, on one maze-lstm DuelingModel built in both packages from the
same weights, with gradients set by hand from numpy.

A step whose loss mode leaves a player out gives that player no gradient:
None in the port (autograd never reached it), zeros in JAX. At static train
mode -1 the JAX package runs one unmasked optimizer with one step count, so
the idle player still steps: its moments decay and its momentum moves it.
At static mode 0 player1 is outside the optimizer and never moves.

Tolerance: every parameter within rtol 1e-6 (atol 1e-9 for entries near
zero) of JAX after each step. Both run float32 on the CPU; only the
clip-norm's sum associates differently.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.config import TrainConfig as JTrainConfig
from active_tracking_rl_tpu.config import parse_env_id
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.rl.learner import make_optimizer_for as j_opt_for
from active_tracking_rl_torch.config import NetConfig, TrainConfig
from active_tracking_rl_torch.models.dueling import build_model, params_from_flax
from active_tracking_rl_torch.rl.optim import make_optimizer_for

ENV_ID = "Track2D-BlockPartialNav-v0"
TOL = dict(rtol=1e-6, atol=1e-9)
#: gradient scales by step: 1.0 makes a global norm far above the clip at
#: 50, 0.01 one below it, so both branches of the clip run.
SCALES = (1.0, 0.01, 0.01, 1.0)


def _grads(params, mode: int, step: int):
    """Gradients as numpy in the flax tree: normal draws on each player the
    loss's mode trains, zeros on the other."""
    rng = np.random.RandomState(100 + step)
    scale = SCALES[step % len(SCALES)]
    out = {}
    for player, tree in params.items():
        live = mode not in (0, 1) or player == f"player{mode}"
        out[player] = jax.tree_util.tree_map(
            lambda p: (scale * rng.standard_normal(p.shape) if live
                       else np.zeros(p.shape)).astype(np.float32), tree)
    return out, {p for p in params if not any(
        np.any(x) for x in jax.tree_util.tree_leaves(out[p]))}


def _run_both(static_mode: int, modes):
    """Yields (jax params, port state_dict) after each step of `modes`."""
    ecfg = parse_env_id(ENV_ID)
    jn = JNetConfig.from_name("maze-lstm", aux="none")
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jt = JTrainConfig(env_id=ENV_ID, train_mode=static_mode)
    opt = j_opt_for(jn, jt, params)
    opt_state = opt.init(params)

    tn = NetConfig.from_name("maze-lstm", aux="none")
    model = build_model(tn, ecfg.num_actions, ecfg.obs_shape, device="cpu")
    model.load_state_dict(params_from_flax(params))
    topt = make_optimizer_for(model, TrainConfig(env_id=ENV_ID,
                                                 train_mode=static_mode))
    named = dict(model.named_parameters())
    for step, mode in enumerate(modes):
        grads, idle = _grads(params, mode, step)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(np.asarray,
                                        optax.apply_updates(params, updates))
        for name, g in params_from_flax(grads).items():
            named[name].grad = None if name.split(".")[0] in idle else g
        topt.step()
        yield params, model.state_dict()


def _assert_close(params, state, what):
    want = params_from_flax(params)
    assert set(want) == set(state)
    for name, w in want.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(), **TOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("modes", [[-1, 0, 0, -1], [0, 0, -1]])
def test_idle_player_steps_as_in_jax(modes):
    """Static mode -1: player1 steps on every iteration, also those whose
    loss mode 0 leaves it without a gradient."""
    for i, (params, state) in enumerate(_run_both(-1, modes)):
        _assert_close(params, state, f"step {i} (mode {modes[i]})")


def test_idle_player_after_the_curriculum_warmup():
    """AD-VAT's curriculum (init_step 1000): player1 idles for 999 steps,
    then learns under a step count of 1000, so its first updates carry
    that count's bias corrections. Its parameters stay put through the
    warm-up and then follow JAX's (jitted update, to keep the test short).
    Player0 is not compared: after a thousand float32 updates a near-zero
    entry drifts past TOL's atol from the order of the clip-norm's sum
    alone. Player1 to rtol 1e-6 / atol 1e-8: its near-zero entries move by
    a step size and a clip factor whose float32 roundings may differ by an
    ulp, and 1e-8 is about one float32 ulp at the parameters' 0.1 scale."""
    ecfg = parse_env_id(ENV_ID)
    jn = JNetConfig.from_name("maze-lstm", aux="none")
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    opt = j_opt_for(jn, JTrainConfig(env_id=ENV_ID, train_mode=-1), params)
    opt_state = opt.init(params)

    @jax.jit
    def jstep(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    model = build_model(NetConfig.from_name("maze-lstm", aux="none"),
                        ecfg.num_actions, ecfg.obs_shape, device="cpu")
    model.load_state_dict(params_from_flax(params))
    topt = make_optimizer_for(model, TrainConfig(env_id=ENV_ID,
                                                 train_mode=-1))
    named = dict(model.named_parameters())
    start = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("player1")}
    warmup = 999
    for step, mode in enumerate([0] * warmup + [-1] * 3):
        grads, idle = _grads(params, mode, step)
        params, opt_state = jstep(grads, opt_state, params)
        for name, g in params_from_flax(grads).items():
            named[name].grad = None if name.split(".")[0] in idle else g
        topt.step()
        if step == warmup - 1:
            assert all(torch.equal(named[k].detach(), v)
                       for k, v in start.items())
        if step < warmup:
            continue
        assert topt.param_groups[0]["step"] == step + 1
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
        for name, w in want.items():
            if name.startswith("player1"):
                np.testing.assert_allclose(named[name].detach().numpy(),
                                           w.numpy(), rtol=1e-6, atol=1e-8,
                                           err_msg=f"step {step}: {name}")
                assert not torch.equal(named[name].detach(), start[name])


def test_shared_step_count_advances_for_every_parameter():
    ecfg = parse_env_id(ENV_ID)
    model = build_model(NetConfig.from_name("maze-lstm", aux="none"),
                        ecfg.num_actions, ecfg.obs_shape, device="cpu")
    opt = make_optimizer_for(model, TrainConfig(env_id=ENV_ID, train_mode=-1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for p in model.player0.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    for p in model.player0.parameters():
        p.grad = None
    opt.step()
    assert [g["step"] for g in opt.param_groups] == [2]
    assert all(len(opt.state[p]) == 3 for p in model.parameters())
    # player1 never had a gradient: zero moments, so it has not moved
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("player1"))


def test_static_mode0_never_moves_player1():
    """Static mode 0: player1 is outside the optimizer; it does not move,
    even on a step whose loss mode -1 gives it a gradient, and the clip
    sees player0 alone."""
    modes = [-1, 0, 0]
    first = None
    for i, (params, state) in enumerate(_run_both(0, modes)):
        _assert_close(params, state, f"step {i} (mode {modes[i]})")
        p1 = {k: v.clone() for k, v in state.items()
              if k.startswith("player1")}
        first = first or p1
        assert all(torch.equal(first[k], v) for k, v in p1.items())
