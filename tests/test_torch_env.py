"""The port's env (active_tracking_rl_torch/envs/) against the JAX package,
bit for bit: config, maps, spawns, navigator candidates and tapes, reset,
step, partial observations, auto-reset, and the committed golden trace.

Every port function takes its randomness as tensors; tests/torch_draws.py
makes them from the same jax.random keys the JAX function splits.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_tracking_rl_tpu import config as jconfig
from active_tracking_rl_tpu.envs import maps as jmaps
from active_tracking_rl_tpu.envs import opponents as jopp
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_torch import config as tconfig
from active_tracking_rl_torch.envs import env as tenv
from active_tracking_rl_torch.envs import maps as tmaps
from active_tracking_rl_torch.envs import opponents as topp
from active_tracking_rl_torch.envs.observe import partial_obs
from active_tracking_rl_torch.ops.noise import Threefry
from tests import oracles
from tests.torch_draws import (assert_state_equal, batch_draws, map_draws,
                               nav_draws, reset_draws, spawn_draws, torch_cfg,
                               torch_state)

FAST = dict(nav_goal_candidates=4, flood_iters=96, tape_len=96)
NAV = "Track2D-BlockPartialNav-v0"


def jcfg(env_id=NAV, **kw):
    return dataclasses.replace(jconfig.parse_env_id(env_id), **{**FAST, **kw})


def keys(n, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


@functools.lru_cache(maxsize=None)
def jax_reset_batch(cfg, n):
    return jax.jit(lambda k: JaxEnv(cfg).reset_batch(k, n))


@functools.lru_cache(maxsize=None)
def jax_step_batch(cfg):
    return jax.jit(JaxEnv(cfg).step_batch)


def t(x):
    return torch.from_numpy(np.array(x))


def test_config_matches_jax():
    assert tconfig.env_ids() == jconfig.env_ids()
    for env_id in jconfig.env_ids():
        want = jconfig.parse_env_id(env_id)
        got = tconfig.parse_env_id(env_id)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), (env_id, f)
        for prop in ("maze_size", "num_actions", "pob_window", "scripted",
                     "w_p", "obs_shape"):
            assert getattr(got, prop) == getattr(want, prop)
    tc, jc = tconfig.TrainConfig(), jconfig.TrainConfig()
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tconfig.net_config_for(tc).name == jconfig.net_config_for(jc).name


@pytest.mark.parametrize("env_id", ["Track2D-BlockPartialNav-v0",
                                    "Track2D-BlockPartialNav-v1",
                                    "Track2D-EmptyPartialNav-v0"])
def test_block_map_matches_jax(env_id):
    cfg = jcfg(env_id)
    ks = keys(6, 1)
    want = jax.vmap(lambda k: jmaps.generate_block_map(cfg, k))(ks)
    got = tmaps.generate_block_map(torch_cfg(cfg), map_draws(cfg, ks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("env_id", [NAV, "Track2D-BlockPartialRPF-v0"])
def test_spawns_match_jax(env_id):
    cfg = jcfg(env_id)
    mk = keys(6, 2)
    mazes = jax.vmap(lambda k: jmaps.generate_block_map(cfg, k))(mk)
    patrol = jmaps.patrol_goals(cfg) if cfg.target_mode == "RPF" else None
    if patrol is not None:
        mazes = jax.vmap(lambda m: jmaps.carve_patrol(m, patrol))(mazes)
    ks = keys(6, 3)
    want_pos, want_goals = jax.vmap(
        lambda k, m: jmaps.sample_spawns(cfg, k, m, patrol))(ks, mazes)
    tp = None if patrol is None else t(patrol)
    got_pos, got_goals = tmaps.sample_spawns(torch_cfg(cfg), t(mazes),
                                             spawn_draws(cfg, ks), tp)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(got_goals.numpy(), np.asarray(want_goals))


def test_sample_around_matches_jax_half_open_window():
    """The window is rows [x-1, x+1) x cols [y-1, y+1): the +1 row and column
    are excluded, as in the JAX package (and the reference)."""
    cfg = jcfg(env_id="Track2D-EmptyPartialNav-v0")
    maze = jmaps.generate_block_map(cfg, jax.random.PRNGKey(0))
    state = jnp.array([40, 40], jnp.int32)
    ks = keys(64, 7)
    want = jax.vmap(lambda k: jmaps.sample_around(k, maze, state, 1))(ks)
    g = jax.vmap(lambda k: jax.random.gumbel(k, (82 * 82,)))(ks)
    got = tmaps.sample_around(t(g), t(maze)[None].repeat(64, 1, 1),
                              t(state)[None].repeat(64, 1), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(map(tuple, got.tolist())) == {(39, 39), (39, 40), (40, 39),
                                             (40, 40)}


def test_nav_candidates_and_tape_match_jax():
    cfg = jcfg()
    n = 4
    mazes = jax.vmap(lambda k: jmaps.generate_block_map(cfg, k))(keys(n, 4))
    pos, goals = jax.vmap(lambda k, m: jmaps.sample_spawns(cfg, k, m))(
        keys(n, 5), mazes)
    ks = keys(n, 6)
    want_c, want_i, want_f = jax.jit(jax.vmap(
        lambda k, m, g: jopp.nav_candidates(cfg, jax.random.split(k)[0], m, g)
    ))(ks, mazes, goals[:, 1])
    want_tape = jax.jit(jax.vmap(
        lambda k, m, s, g: jopp.nav_tape(cfg, k, m, s, g)))(
            ks, mazes, pos[:, 1], goals[:, 1])
    tc, d = torch_cfg(cfg), nav_draws(cfg, ks)
    got_c, got_i, got_f = topp.nav_candidates(tc, t(mazes), t(goals[:, 1]),
                                              d.candidates)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i)[0])
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    got_tape = topp.nav_tape(tc, t(mazes), t(pos[:, 1]), t(goals[:, 1]), d)
    np.testing.assert_array_equal(got_tape.numpy(), np.asarray(want_tape))


def test_nav_tape_walks_legal_moves():
    """Simulating the tape with the oracle dynamics stays on free cells."""
    cfg = jcfg(tape_len=200)
    tc = torch_cfg(cfg)
    gen = Threefry().manual_seed(0)
    draws = tenv.draw_reset(tc, 2, gen, "cpu")
    state, _ = tenv.reset(tc, draws)
    for row in range(2):
        maze = state.maze[row, 6:-6, 6:-6].numpy()
        p = tuple(int(x) for x in state.pos[row, 1])
        for a in state.tape[row].tolist():
            p, _ = oracles.next_state(maze, p, a)
            assert maze[p] == 0


@pytest.mark.parametrize("env_id,fast", [
    (NAV, True), (NAV, False), ("Track2D-EmptyPartialNav-v1", True),
    ("Track2D-BlockPartialNav-v1", True), ("Track2D-EmptyPartialNav-v0", True)])
def test_reset_matches_jax(env_id, fast):
    cfg = jcfg(env_id) if fast else jconfig.parse_env_id(env_id)
    n = 4 if fast else 2
    key = jax.random.PRNGKey(11)
    want_state, want_obs = jax_reset_batch(cfg, n)(key)
    got_state, got_obs = tenv.reset(torch_cfg(cfg), batch_draws(cfg, key, n))
    assert_state_equal(got_state, want_state)
    np.testing.assert_array_equal(got_obs.numpy(), np.asarray(want_obs))


@pytest.mark.parametrize("env_id", [NAV, "Track2D-BlockPartialPZR-v0"])
def test_step_matches_jax(env_id):
    cfg = jcfg(env_id)
    n = 6
    state, _ = jax_reset_batch(cfg, n)(jax.random.PRNGKey(12))
    tstate = torch_state(state)
    tc = torch_cfg(cfg)
    rng = np.random.RandomState(0)
    for _ in range(40):
        a = rng.randint(0, 4, size=(n, 2)).astype(np.int32)
        state, obs, rew, done, _ = jax_step_batch(cfg)(state, a)
        tstate, tobs, trew, tdone, _ = tenv.step(tc, tstate, torch.from_numpy(a))
        assert_state_equal(tstate, state)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(rew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(done))


def test_partial_obs_matches_oracle():
    """Random positions, overlaps and agents outside each other's window."""
    cfg = tconfig.parse_env_id("Track2D-BlockPartialPZR-v0")
    rng = np.random.RandomState(1)
    gen = Threefry().manual_seed(1)
    maze = tmaps.generate_block_map(cfg, tmaps.draw_map(cfg, 1, gen, "cpu"))[0]
    mp = torch.nn.functional.pad(maze, (6, 6, 6, 6), value=1)
    pos = rng.randint(1, 81, size=(64, 2, 2)).astype(np.int32)
    pos[0, 1] = pos[0, 0]                       # overlap
    pos[1, 1] = pos[1, 0] + np.array([6, -6])   # window corner
    pos[2, 1] = pos[2, 0] + np.array([7, 0])    # just outside
    pos = np.clip(pos, 1, 80)
    got = partial_obs(cfg, mp[None].repeat(64, 1, 1), torch.from_numpy(pos))
    for row in range(64):
        for i in range(2):
            want = oracles.partial_obs(maze.numpy(), [tuple(p) for p in pos[row]],
                                       i)
            np.testing.assert_array_equal(got[row, i].numpy(), want)


@pytest.mark.parametrize("blocks", [1, 2])
def test_autoreset_matches_jax(blocks):
    cfg = jcfg()
    env_j = JaxEnv(cfg)
    state, obs = jax_reset_batch(cfg, 8)(jax.random.PRNGKey(13))
    pool, pool_obs = jax_reset_batch(cfg, 4)(jax.random.PRNGKey(14))
    done = jnp.array([1, 0, 1, 1, 0, 0, 1, 1], bool)
    ptr = jnp.int32(3) if blocks == 1 else jnp.array([1, 0], jnp.int32)
    ws, wo, wp = env_j.autoreset(state, obs, done, pool, pool_obs, ptr)
    tenv_ = tenv.TrackEnv(torch_cfg(cfg), "cpu")
    gs, go, gp = tenv_.autoreset(torch_state(state), t(obs), t(done),
                                 torch_state(pool), t(pool_obs),
                                 t(ptr).long())
    assert_state_equal(gs, ws)
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_reset_batch_chunked():
    """One chunk is reset_batch exactly; several chunks give the same shapes,
    each chunk drawing its own rows."""
    env = tenv.TrackEnv(torch_cfg(jcfg()), "cpu")
    a, ao = env.reset_batch(4, Threefry().manual_seed(3))
    b, bo = env.reset_batch_chunked(4, Threefry().manual_seed(3))
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    assert torch.equal(ao, bo)
    c, co = env.reset_batch_chunked(5, Threefry().manual_seed(3),
                                    chunk_max=2)
    assert c.pos.shape == (5, 2, 2) and co.shape == (5, 2, 13, 13)
    gen = Threefry().manual_seed(3)
    first, _ = env.reset_batch(2, gen)
    assert torch.equal(c.maze[:2], first.maze)


def test_golden_trace_replays_bit_exact():
    """tests/golden/Track2D-BlockPartialNav-v0.npz: the port's reset (fed the
    trace's own keys) and step reproduce obs, rewards, done, pos and dist."""
    g = np.load("tests/golden/Track2D-BlockPartialNav-v0.npz")
    env_id = str(g["env_id"])
    jc = jconfig.parse_env_id(env_id)
    tc = torch_cfg(jc)
    key = jax.random.PRNGKey(int(g["seed"]))
    obs_i = pos_i = step_i = 0
    for _ in range(int(g["episodes"])):
        key, k = jax.random.split(key)
        state, obs = tenv.reset(tc, reset_draws(jc, k[None]))
        np.testing.assert_array_equal(obs[0].numpy(), g["obs"][obs_i])
        np.testing.assert_array_equal(state.pos[0].numpy(), g["pos"][pos_i])
        obs_i += 1
        pos_i += 1
        done, steps = False, 0
        while not done and steps < 80:
            a = torch.from_numpy(g["actions"][step_i][None].astype(np.int32))
            state, obs, rew, d, info = tenv.step(tc, state, a)
            np.testing.assert_array_equal(obs[0].numpy(), g["obs"][obs_i])
            np.testing.assert_array_equal(rew[0].numpy(), g["rewards"][step_i])
            np.testing.assert_array_equal(state.pos[0].numpy(), g["pos"][pos_i])
            assert bool(d[0]) == bool(g["done"][step_i])
            assert float(info["distance"][0]) == g["dist"][step_i]
            done = bool(d[0])
            obs_i += 1
            pos_i += 1
            step_i += 1
            steps += 1
    assert step_i == len(g["actions"])
