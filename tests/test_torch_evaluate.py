"""The port's greedy evaluator (active_tracking_rl_torch/rl/evaluate.py)
against the JAX package's ``rl/evaluate.py`` on the same reset draws
(tests/torch_draws.py re-derives the draws of JAX's reset key), on the Nav
env that AD-VAT evaluates on (its ``env_base``), at reduced tape and flood
sizes. A freshly initialized tat-maze-lstm loses the target within a few
dozen steps, so episodes end before max_steps and their rows are frozen;
the committed AD-VAT checkpoint keeps most episodes to the end.

Greedy actions, episode lengths and successes must match exactly. Returns
and the float metrics agree to rtol 1e-5 / atol 1e-5: both sum the same
float32 rewards in the same order, and only the means and deviations over
episodes reduce in another order.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
from flax import serialization

from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.config import parse_env_id
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.rl.evaluate import make_evaluator as j_evaluator
from active_tracking_rl_torch.config import NetConfig, preset
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import build_model, params_from_flax
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.evaluate import evaluate, make_evaluator
from tests.torch_draws import batch_draws, torch_cfg

TOL = dict(rtol=1e-5, atol=1e-5)
EPISODES, MAX_STEPS = 8, 40
FAST = dict(nav_goal_candidates=4, flood_iters=96, tape_len=96)
RUN = Path(__file__).resolve().parents[1] / (
    "runs/r5-advat-s3-ext2/Track2D-BlockPartialPZR-v0/Aug21_19-24")


def _params(source):
    if source == "init":
        jm = jbuild(JNetConfig.from_name("tat-maze-lstm"), 4, (13, 13))
        return jm.init(jax.random.PRNGKey(0))
    return {f"player{i}": serialization.msgpack_restore(
        (RUN / f"{who}-best.msgpack").read_bytes())
        for i, who in enumerate(("tracker", "target"))}


@pytest.fixture(scope="module")
def ecfg():
    return dataclasses.replace(parse_env_id(preset("advat-2d").env_base),
                               **FAST)


def _port(params, ecfg):
    """The port's model with `params`, its eval env and net config, on the
    CPU."""
    tn = NetConfig.from_name("tat-maze-lstm")
    model = build_model(tn, ecfg.num_actions, ecfg.obs_shape, device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model, TrackEnv(torch_cfg(ecfg), "cpu"), tn


@pytest.mark.parametrize("source", ["init", "advat"])
def test_evaluator_matches_jax(ecfg, source):
    params = _params(source)
    jn = JNetConfig.from_name("tat-maze-lstm")
    jm = jbuild(jn, ecfg.num_actions, ecfg.obs_shape)
    key = jax.random.PRNGKey(11)
    want = j_evaluator(jm, JaxEnv(ecfg), jn, EPISODES, MAX_STEPS)(params, key)
    model, env, tn = _port(params, ecfg)
    k_env, _ = jax.random.split(key)
    got = make_evaluator(model, env, tn, EPISODES, MAX_STEPS)(
        draws=batch_draws(ecfg, k_env, EPISODES))
    assert set(got) == set(want)
    for name in ("ep_lens", "ep_success"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("R_mean", "R_std", "EL_mean", "EL_std", "R_step", "S_rate",
                 "ep_returns"):
        np.testing.assert_allclose(got[name], want[name], **TOL,
                                   err_msg=name)
        assert got[name].dtype == want[name].dtype, name
    lens = got["ep_lens"]
    if source == "init":        # rows that finished early were frozen
        assert (lens < MAX_STEPS).sum() >= EPISODES // 2
    else:
        assert got["S_rate"] > 0.5


def test_evaluate_draws_from_its_generator(ecfg):
    """From a generator: the same seed gives the same episodes, another
    seed other ones; the metrics are consistent with the per-episode arrays."""
    model, env, tn = _port(_params("init"), ecfg)
    runs = [evaluate(model, env, tn, Threefry().manual_seed(s),
                     EPISODES, MAX_STEPS) for s in (1, 1, 2)]
    assert all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])
    assert not np.array_equal(runs[0]["ep_returns"], runs[2]["ep_returns"])
    out = runs[0]
    assert out["ep_returns"].shape == (EPISODES, 2)
    assert 1 <= out["ep_lens"].min() and out["ep_lens"].max() <= MAX_STEPS
    np.testing.assert_allclose(out["EL_mean"], out["ep_lens"].mean(), **TOL)
    np.testing.assert_array_equal(out["ep_success"],
                                  out["ep_lens"] >= MAX_STEPS)
