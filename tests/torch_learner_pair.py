"""Train steps of the JAX package and of the port from the same params,
carry, reset pool and sampling noise, for any discrete network, optimizer,
frame stack and static train mode, one step (``run_pair``) or several at
given loss modes in turn (``run_steps``, which also takes ``bf16``): the
harness of the learner parity tests. ``build_pair`` sets both steps up
for tests that drive the env and pool themselves.

The port takes its sampling noise as tensors; ``step_noise`` re-derives it
from the keys that the JAX step splits, so both sample the same actions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.config import TrainConfig as JTrainConfig
from active_tracking_rl_tpu.config import parse_env_id
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.rl.learner import make_optimizer_for as j_opt_for
from active_tracking_rl_tpu.rl.learner import make_train_step as j_train_step
from active_tracking_rl_tpu.rl.rollout import TrainCarry as JCarry
from active_tracking_rl_torch.config import NetConfig, TrainConfig
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import build_model, params_from_flax
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.learner import init_pool_ptr, make_train_step
from active_tracking_rl_torch.rl.optim import make_optimizer_for
from active_tracking_rl_torch.rl.rollout import TrainCarry
from tests.torch_draws import (assert_state_equal, capture_grads, step_noise,
                               torch_cfg, torch_state)

#: reduced scripted-tape sizes (the floods and tapes stay exact)
FAST = dict(nav_goal_candidates=4, flood_iters=96, tape_len=96)
B, P, T = 8, 8, 8
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def run_pair(env_id: str, network: str, optimizer: str = "Adam",
             stack: int = 1, train_mode: int = 0, aux: str = "reward"):
    """Both packages' step from one state -> dict(jax=(params', grads,
    carry', metrics, ptr'), torch=(state_dict', grads, carry', metrics,
    ptr'))."""
    return run_steps(env_id, network, (train_mode,), optimizer, stack,
                     train_mode, aux)[0]


class Pair(NamedTuple):
    """Both packages' train steps at one configuration (``build_pair``)."""

    jenv: object
    params: dict            # JAX's initial params, the port's model loaded
    opt: object             # JAX's optimizer
    step: object            # JAX's jitted step
    env: TrackEnv
    model: torch.nn.Module
    tstep: object           # the port's step
    topt: torch.optim.Optimizer
    tcfg: TrainConfig


def build_pair(ecfg, env_id: str, network: str = "tat-maze-lstm",
               train_mode: int = 0, stack: int = 1, num_envs: int = B,
               num_steps: int = T, optimizer: str = "Adam",
               aux: str = "reward", bf16: bool = False, grads: bool = False,
               reset_pool: int = None, remat: bool = False,
               lift=None) -> Pair:
    """Both packages' train steps of `network` on `ecfg` with an external
    pool of `reset_pool` rows (default `num_envs`), from one set of initial
    params; with `grads` JAX's optimizer state also hands back the raw
    gradients; `remat` as ``TrainConfig.remat`` in both (the trainer CLIs
    train with it on); `lift(jenv, model)`, if given, runs before either
    optimizer or step is built (tests/torch_to_jax.py's float64 pair)."""
    sizes = dict(env_id=env_id, num_envs=num_envs,
                 reset_pool=reset_pool or num_envs, num_steps=num_steps,
                 train_mode=train_mode, optimizer=optimizer, remat=remat)
    jenv = JaxEnv(ecfg)
    jn = dataclasses.replace(
        JNetConfig.from_name(network, stack_frames=stack, aux=aux), bf16=bf16)
    jt = JTrainConfig(**sizes)
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    params = jm.init(jax.random.PRNGKey(0))
    env = TrackEnv(torch_cfg(ecfg), "cpu")
    tt = TrainConfig(**sizes)
    tn = dataclasses.replace(
        NetConfig.from_name(network, stack_frames=stack, aux=aux), bf16=bf16)
    model = build_model(tn, ecfg.num_actions, ecfg.obs_shape, device="cpu")
    model.load_state_dict(params_from_flax(_host(params)))
    if lift is not None:
        lift(jenv, model)
    opt = j_opt_for(jn, jt, params)
    if grads:
        opt = capture_grads(opt)
    step = jax.jit(j_train_step(jm, jenv, jn, jt, opt, external_pool=True))
    topt = make_optimizer_for(model, tt)
    ts = make_train_step(model, env, tn, tt, topt)
    return Pair(jenv, params, opt, step, env, model, ts, topt, tt)


def run_steps(env_id: str, network: str, modes, optimizer: str = "Adam",
              stack: int = 1, train_mode: int = 0, aux: str = "reward",
              bf16: bool = False):
    """Both packages' steps at the loss modes `modes` in turn, from one
    state and on one reset pool (its pointer threaded through), under a
    static `train_mode`, with ``NetConfig.bf16`` = `bf16` in both -> per
    step, run_pair's dict."""
    ecfg = dataclasses.replace(parse_env_id(env_id), **FAST)
    jenv, params, opt, step, env, model, ts, *_ = build_pair(
        ecfg, env_id, network, train_mode, stack, optimizer=optimizer,
        aux=aux, bf16=bf16, grads=True)
    reset = jax.jit(lambda k: jenv.reset_batch(k, B))
    state, obs = reset(jax.random.PRNGKey(1))
    pool_state, pool_obs = reset(jax.random.PRNGKey(2))
    stack_obs = jnp.repeat(obs[:, :, None], stack, axis=2)
    hx = jnp.zeros((B, 2, model.cfg.rnn_out), jnp.float32)
    carry = JCarry(state, stack_obs, hx, hx, jax.random.PRNGKey(3))
    tcarry = TrainCarry(torch_state(state),
                        torch.from_numpy(np.array(stack_obs)),
                        torch.from_numpy(np.array(hx)),
                        torch.from_numpy(np.array(hx)),
                        Threefry().manual_seed(0))
    tpool = (torch_state(pool_state), torch.from_numpy(np.array(pool_obs)))

    opt_state, ptr = opt.init(params), jnp.int32(0)
    tptr = init_pool_ptr(device="cpu")
    runs = []
    for mode in modes:
        noise = step_noise(carry.key, T, B, env.cfg.num_actions)
        params, opt_state, carry, m, ptr = step(
            params, opt_state, carry, jnp.int32(mode),
            (pool_state, pool_obs, ptr))
        tcarry, tm, tptr = ts(tcarry, mode, (*tpool, tptr), noise)
        tgrads = {n: (p.grad.clone() if p.grad is not None
                      else torch.zeros_like(p))
                  for n, p in model.named_parameters()}
        runs.append(dict(
            jax=(_host(params), _host(opt_state[1]), carry, m, ptr),
            torch=({k: v.clone() for k, v in model.state_dict().items()},
                   tgrads, tcarry, tm, tptr)))
    return runs


def assert_pair_close(res, param_tol) -> None:
    """Integer paths bit for bit; loss, metrics and gradients to GRAD_TOL;
    the updated parameters to `param_tol`."""
    p1, grads, c1, m1, ptr1 = res["jax"]
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
    want = params_from_flax(grads)
    assert set(want) == set(tgrads)
    for name, g in want.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(),
                                   **GRAD_TOL, err_msg=name)
    for name, w in params_from_flax(p1).items():
        np.testing.assert_allclose(tp1[name].numpy(), w.numpy(), **param_tol,
                                   err_msg=name)
