"""Three recipes' train steps against the JAX package, one step each from
the same params, carry, reset pool and sampling noise (tat-maze-lstm):

* ``Track2D-BlockPartialFar-v0`` at train mode -1 (tracker, target and aux
  head all learn): the target is paid to stay far (``w_p = -0.5``), the
  reward branch that only RESULTS.md §1.7's Far run trains;
* ``Track2D-MazePartialPZR-v0`` at mode -1: AD-VAT on Maze maps, whose
  start state and reset pool come from the maze walk;
* ``Track2D-BlockPartialNav-v0`` at mode 0 with a stack of 4 frames
  (§1.9's stack-4 run), whose pool resets refill the whole stack; Nav
  tapes at the learner tests' reduced sizes (tests/torch_learner_pair.py).

The port resets its start state and pool itself from the draws of JAX's
``reset_batch`` (tests/torch_draws.py:batch_draws), and those must equal
JAX's bit for bit. Both start states are then moved the same way so that
one step of 8 reaches what a fresh reset does not: in four rows the
target stands at the free cell farthest from the tracker, beyond the
window, where ``w_p`` sets its reward and the episode ends after three
steps lost; two more rows end at the time limit after three steps. Six
rows then reset from the pool. Every integer path of the step (env state,
frame stack, pool pointer, episode counts) must equal JAX's bit for bit. Tolerances for the float paths are
tests/test_torch_learner_advat.py's: loss, metrics and gradients rtol 1e-4
/ atol 1e-5, updated params rtol 1e-5 / atol 1e-6.

Last, the trainer CLI's ``--load-model-dir`` (RESULTS.md §1.6's warm-started
RPF run) starts from exactly the parameters of an ``all-best.msgpack`` that
the JAX package's CheckpointManager wrote.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import active_tracking_rl_torch.run.train as train_mod
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.config import parse_env_id
from active_tracking_rl_tpu.envs.observe import observe as j_observe
from active_tracking_rl_tpu.envs.types import EnvState as JEnvState
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.rl.checkpoint import \
    CheckpointManager as JCheckpointManager
from active_tracking_rl_tpu.rl.rollout import TrainCarry as JCarry
from active_tracking_rl_torch.envs.observe import observe
from active_tracking_rl_torch.envs.types import EnvState
from active_tracking_rl_torch.models.dueling import params_from_flax
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.learner import init_pool_ptr
from active_tracking_rl_torch.rl.rollout import TrainCarry
from active_tracking_rl_torch.utils.logging import MetricWriter
from tests.torch_draws import assert_state_equal, batch_draws, step_noise
from tests.torch_learner_pair import FAST, _host, build_pair

FAR = "Track2D-BlockPartialFar-v0"
MAZE_PZR = "Track2D-MazePartialPZR-v0"
NAV = "Track2D-BlockPartialNav-v0"
RPF = "Track2D-BlockPartialRPF-v0"
#: env id -> (train mode, frames stacked)
RECIPES = {FAR: (-1, 1), MAZE_PZR: (-1, 1), NAV: (0, 4)}
B, P, T = 8, 8, 8
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _far_and_late(cfg, state) -> dict:
    """`state`'s fields as numpy arrays, moved as the module docstring says:
    rows 0-3 lost (the target at the farthest free cell, c_far 8), rows 4-5
    three steps short of the time limit."""
    s = {f.name: np.array(getattr(state, f.name))
         for f in dataclasses.fields(EnvState)}
    p = cfg.pob_size
    for i in range(4):
        free = np.argwhere(s["maze"][i, p:-p, p:-p] == 0).astype(np.int32)
        far = free[((free - s["pos"][i, 0]) ** 2).sum(1).argmax()]
        assert np.sqrt(((far - s["pos"][i, 0]) ** 2).sum()) > p + 8
        s["pos"][i, 1] = far
        s["c_far"][i] = 8
    s["t"][4:6] = cfg.max_episode_steps - 3
    s["dist"] = np.sqrt(((s["pos"][:, 1] - s["pos"][:, 0]) ** 2).sum(-1)
                        ).astype(np.float32)
    return s


@pytest.fixture(scope="module", params=list(RECIPES))
def pair(request):
    """One train step of each package at the recipe's mode -> dict(env_id,
    mode, jax=(reset state, pool, moved start state, params', grads,
    carry', metrics, ptr'), torch=(the same, with state_dict' for
    params'))."""
    env_id = request.param
    mode, stack = RECIPES[env_id]
    ecfg = parse_env_id(env_id)
    if ecfg.target_mode == "Nav":
        ecfg = dataclasses.replace(ecfg, **FAST)
    jenv, params, opt, step, env, model, ts, *_ = build_pair(
        ecfg, env_id, "tat-maze-lstm", mode, stack, B, T, grads=True)
    reset = jax.jit(lambda k: jenv.reset_batch(k, B))
    keys = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    (state0, obs0), (pool_state, pool_obs) = (reset(k) for k in keys)
    state = JEnvState(**{k: jnp.asarray(v) for k, v in
                         _far_and_late(ecfg, state0).items()})
    obs = jax.vmap(lambda m, q: j_observe(ecfg, m, q))(state.maze, state.pos)
    hx = jnp.zeros((B, 2, 128), jnp.float32)
    carry = JCarry(state, jnp.repeat(obs[:, :, None], stack, axis=2), hx, hx,
                   jax.random.PRNGKey(3))

    tc = env.cfg
    tstate0, tobs0 = env.reset(batch_draws(ecfg, keys[0], B))
    tpool = env.reset(batch_draws(ecfg, keys[1], P))
    tstate = EnvState(**{k: torch.from_numpy(v) for k, v in
                         _far_and_late(ecfg, tstate0).items()})
    tobs = observe(tc, tstate.maze, tstate.pos)
    tcarry = TrainCarry(tstate, tobs[:, :, None].repeat(1, 1, stack, 1, 1),
                        torch.zeros(B, 2, 128),
                        torch.zeros(B, 2, 128),
                        Threefry().manual_seed(0))

    noise = step_noise(carry.key, T, B, tc.num_actions)
    params, opt_state, carry, m, ptr = step(
        params, opt.init(params), carry, jnp.int32(mode),
        (pool_state, pool_obs, jnp.int32(0)))
    tcarry, tm, tptr = ts(tcarry, mode, (*tpool, init_pool_ptr(device="cpu")),
                          noise)
    tgrads = {n: (p.grad.clone() if p.grad is not None
                  else torch.zeros_like(p))
              for n, p in model.named_parameters()}
    return dict(
        env_id=env_id, mode=mode,
        jax=((state0, obs0), (pool_state, pool_obs), (state, obs),
             _host(params), _host(opt_state[1]), carry, m, ptr),
        torch=((tstate0, tobs0), tpool, (tstate, tobs), model.state_dict(),
               tgrads, tcarry, tm, tptr))


def test_recipes_are_the_branches_named():
    far, maze = parse_env_id(FAR), parse_env_id(MAZE_PZR)
    assert (far.target_mode, far.map_type, far.w_p) == ("Far", "Block", -0.5)
    assert (maze.target_mode, maze.map_type, maze.w_p) == ("PZR", "Maze", 1.0)
    assert parse_env_id(NAV).target_mode == "Nav"


def test_port_resets_start_and_pool_as_jax(pair):
    """The reset state, the pool, and the moved start state with its
    observations, each package's own."""
    for i in (0, 1, 2):
        (state, obs), (tstate, tobs) = pair["jax"][i], pair["torch"][i]
        assert_state_equal(tstate, state)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))


def test_step_integer_paths_bit_exact(pair):
    """Six rows reset from the pool; with a stack, each refills all frames."""
    *_, c1, m1, ptr1 = pair["jax"]
    *_, tc1, tm1, tptr1 = pair["torch"]
    assert_state_equal(tc1.env_state, c1.env_state)
    np.testing.assert_array_equal(tc1.obs_stack.numpy(),
                                  np.asarray(c1.obs_stack))
    assert int(tptr1) == int(ptr1) == 6         # six rows reset from the pool
    assert float(tm1.ep_count) == float(m1.ep_count) == 6
    np.testing.assert_array_equal(tm1.ep_len.numpy(), np.asarray(m1.ep_len))


def test_loss_and_metrics_match_jax(pair):
    m1, tm1 = pair["jax"][6], pair["torch"][6]
    for name in ("loss", "policy_loss", "value_loss", "entropy", "ep_return",
                 "pred_loss", "grad_norm"):
        np.testing.assert_allclose(getattr(tm1, name).numpy(),
                                   np.asarray(getattr(m1, name)), **GRAD_TOL,
                                   err_msg=name)
    # the target's loss and the aux loss enter at mode -1 only
    players = tm1.policy_loss + 0.5 * tm1.value_loss
    want = players[0] + (players[1] + tm1.pred_loss if pair["mode"] else 0.0)
    np.testing.assert_allclose(tm1.loss.item(), want.item(), rtol=1e-5,
                               atol=1e-5)


def test_grads_match_jax(pair):
    grads = params_from_flax(pair["jax"][4])
    tgrads = pair["torch"][4]
    assert set(grads) == set(tgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(),
                                   **GRAD_TOL, err_msg=name)
    assert any(g.any() for n, g in grads.items() if n.startswith("player0"))
    # the target learns at mode -1 only
    assert any(g.any() for n, g in grads.items()
               if n.startswith("player1")) == bool(pair["mode"])


def test_updated_params_match_jax(pair):
    want = params_from_flax(pair["jax"][3])
    got = pair["torch"][3]
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), **PARAM_TOL,
                                   err_msg=name)


def test_cli_load_model_dir_starts_from_a_jax_checkpoint(tmp_path,
                                                         monkeypatch):
    """`run.train --load-model-dir all-best.msgpack`, the file written by
    the JAX package's CheckpointManager, holds exactly its parameters in
    both players once set up, and not the seed's own initialisation."""
    monkeypatch.setattr(train_mod, "MetricWriter",
                        functools.partial(MetricWriter,
                                          use_tensorboard=False))
    ecfg = parse_env_id(RPF)
    jm = jbuild(JNetConfig.from_name("tat-maze-lstm"), ecfg.num_actions,
                ecfg.obs_shape)
    params = jm.init(jax.random.PRNGKey(7))
    JCheckpointManager(str(tmp_path / "nav")).save(params, None, score=1.0,
                                                   n_iter=200)
    flags = ["--device", "cpu", "--env", RPF, "--env-base", RPF,
             "--network", "tat-maze-lstm", "--train-mode", "0",
             "--num-envs", "8", "--reset-pool", "4", "--num-steps", "4",
             "--total-iters", "1", "--log-dir", str(tmp_path)]
    want = params_from_flax(_host(params))
    for name, load in (("cold", []), ("warm", [
            "--load-model-dir", str(tmp_path / "nav" / "all-best.msgpack")])):
        s = train_mod.setup(flags + ["--run-name", name] + load)
        try:
            got = s.model.state_dict()
            assert set(got) == set(want)
            same = [torch.equal(got[k], w) for k, w in want.items()]
            assert all(same) if load else not all(same)
        finally:
            train_mod.close_logger(s.log)
