"""The port's SharedRMSprop (active_tracking_rl_torch/rl/optim.py) against
the JAX package's ``make_optimizer("RMSprop", ...)`` behind
``make_optimizer_for``, step by step, on one maze-gru DuelingModel built in
both packages from the same weights, with gradients set by hand from numpy
(tests/test_torch_optim.py's draws: scales 1.0 and 0.01 put the global norm
above and below the clip at 50, so both branches of the clip run).

A step whose loss mode leaves a player out gives that player no gradient:
None in the port, zeros in JAX. At static train mode -1 the idle player
still steps: its update is zero, but its square average decays by alpha,
which the next step's update divides by. At static mode 0 player1 is
outside the optimizer and never moves.

Tolerance: every parameter within rtol 1e-6 (atol 1e-9 for entries near
zero) of JAX after each step, as for SharedAdam; both run float32 on the
CPU and only the clip-norm's sum associates differently.
"""

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
from active_tracking_rl_torch.rl.optim import (SharedRMSprop,
                                               make_optimizer_for)
from tests.test_torch_optim import _grads

ENV_ID = "Track2D-BlockPartialNav-v0"
NET = "maze-gru"
TOL = dict(rtol=1e-6, atol=1e-9)


def _run_both(static_mode: int, modes, lr=1e-3):
    """Yields (jax params, port state_dict, port optimizer) after each step."""
    ecfg = parse_env_id(ENV_ID)
    jn = JNetConfig.from_name(NET, aux="none")
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jt = JTrainConfig(env_id=ENV_ID, train_mode=static_mode,
                      optimizer="RMSprop", lr=lr)
    opt = j_opt_for(jn, jt, params)
    opt_state = opt.init(params)

    model = build_model(NetConfig.from_name(NET, aux="none"),
                        ecfg.num_actions, ecfg.obs_shape, device="cpu")
    model.load_state_dict(params_from_flax(params))
    topt = make_optimizer_for(model, TrainConfig(
        env_id=ENV_ID, train_mode=static_mode, optimizer="RMSprop", lr=lr))
    assert isinstance(topt, SharedRMSprop)
    named = dict(model.named_parameters())
    for step, mode in enumerate(modes):
        grads, idle = _grads(params, mode, step)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(np.asarray,
                                        optax.apply_updates(params, updates))
        for name, g in params_from_flax(grads).items():
            named[name].grad = None if name.split(".")[0] in idle else g
        topt.step()
        yield params, model.state_dict(), topt


def _assert_close(params, state, what):
    want = params_from_flax(params)
    assert set(want) == set(state)
    for name, w in want.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(), **TOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("modes", [[-1, 0, 0, -1], [0, -1, -1, 0, -1]])
def test_rmsprop_steps_as_in_jax(modes):
    for i, (params, state, _) in enumerate(_run_both(-1, modes)):
        _assert_close(params, state, f"step {i} (mode {modes[i]})")


def test_idle_player_square_average_decays():
    """Static mode -1, loss modes [-1, 0]: player1's gradient is zero at the
    second step, so its parameters hold still while its square average
    decays by alpha = 0.99."""
    run = _run_both(-1, [-1, 0])
    _, state, opt = next(run)
    player1 = [p for n, p in _opt_named(opt, state) if n.startswith("player1")]
    before = [p.clone() for p in player1]
    sq_before = [opt.state[p]["square_avg"].clone() for p in player1]
    next(run)
    assert opt.param_groups[0]["step"] == 2
    for p, b, sq in zip(player1, before, sq_before):
        assert torch.equal(p, b)
        assert torch.equal(opt.state[p]["square_avg"], 0.99 * sq)
        assert sq.any()


def _opt_named(opt, state):
    """(name, parameter) of the optimizer's parameters, by storage."""
    names = {t.data_ptr(): n for n, t in state.items()}
    return [(names[p.data_ptr()], p) for p in opt.param_groups[0]["params"]]


def test_static_mode0_never_moves_player1():
    modes = [-1, 0, -1]
    first = None
    for i, (params, state, _) in enumerate(_run_both(0, modes)):
        _assert_close(params, state, f"step {i} (mode {modes[i]})")
        p1 = {k: v.clone() for k, v in state.items()
              if k.startswith("player1")}
        first = first or p1
        assert all(torch.equal(first[k], v) for k, v in p1.items())
