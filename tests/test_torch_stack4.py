"""Frame stacks of 4 through the port (ROADMAP §1 item 4): one train step
against the JAX package's at stack 4 (maze-lstm on
Track2D-BlockPartialNav-v0, train mode 0; tests/torch_learner_pair.py), and
the committed stack-4 checkpoint (tat-maze-lstm, 4 frames, trained on
Track2D-BlockPartialNav-v0) acting greedily in both packages for 12 joint
steps from the same resets.

Tolerances of the train step as in tests/test_torch_learner.py: integer
paths bit for bit, loss and gradients rtol 1e-4 / atol 1e-5, updated params
rtol 1e-5 / atol 1e-6. Greedy actions and env states must be equal at every
step; values to rtol 1e-5 / atol 1e-5 (float32 forwards on both sides).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.config import parse_env_id
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import build_model
from active_tracking_rl_torch.rl.checkpoint import load_file, load_params
from active_tracking_rl_torch.rl.rollout import (obs_to_model, stack_fill,
                                                 stack_push)
from tests.torch_draws import assert_state_equal, batch_draws, torch_cfg
from tests.torch_learner_pair import FAST, assert_pair_close, run_pair

RUN = Path(__file__).resolve().parents[1] / (
    "runs/r4-stack4/Track2D-BlockPartialNav-v0/Aug21_10-32")
ROWS, STEPS, K = 8, 12, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def test_stack4_train_step_matches_jax():
    assert_pair_close(run_pair("Track2D-BlockPartialNav-v0", "maze-lstm",
                               stack=K, aux="none"),
                      dict(rtol=1e-5, atol=1e-6))


def test_stack4_checkpoint_greedy_actions_match_jax():
    ecfg = dataclasses.replace(parse_env_id("Track2D-BlockPartialNav-v0"),
                               **FAST)
    files = {p: str(RUN / f"{who}-best.msgpack")
             for p, who in (("player0", "tracker"), ("player1", "target"))}
    params = {p: load_file(f) for p, f in files.items()}
    jn = JNetConfig.from_name("tat-maze-lstm", stack_frames=K)
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    jenv = JaxEnv(ecfg)
    tn = NetConfig.from_name("tat-maze-lstm", stack_frames=K)
    model = build_model(tn, ecfg.num_actions, ecfg.obs_shape, device="cpu")
    load_params(model, None, files["player0"], files["player1"])
    env = TrackEnv(torch_cfg(ecfg), "cpu")

    key = jax.random.PRNGKey(4)
    jstate, jobs = jax.jit(lambda k: jenv.reset_batch(k, ROWS))(key)
    state, obs = env.reset(batch_draws(ecfg, key, ROWS))
    jstack = jnp.repeat(jobs[:, :, None], K, axis=2)
    stack = stack_fill(obs, K)
    jh = jnp.zeros((ROWS, 2, 128), jnp.float32)
    jc, h, c = jh, torch.zeros(ROWS, 2, 128), torch.zeros(ROWS, 2, 128)
    jstep = jax.jit(lambda p, s, h, c: jm.step_both(
        p, s.astype(jnp.float32)[..., None], h, c, jax.random.PRNGKey(0),
        test=True))
    jenv_step = jax.jit(jenv.step_batch)
    moved = 0
    for t in range(STEPS):
        jv, ja, _, _, jh, jc, _ = jstep(params, jstack, jh, jc)
        with torch.no_grad():
            v, a, _, _, h, c, _ = model.step_both(obs_to_model(stack), h, c,
                                                  None, test=True)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja),
                                      err_msg=f"step {t}")
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
        jstate, jobs, *_ = jenv_step(jstate, ja)
        state, obs, *_ = env.step(state, a)
        assert_state_equal(state, jstate)
        jstack = jnp.concatenate([jstack[:, :, 1:], jobs[:, :, None]], axis=2)
        stack = stack_push(stack, obs)
        moved += int((a[:, 0] != a[0, 0]).any())
    # the tracker's greedy actions are not one constant action
    assert moved > 0
