"""The parts of the port's env that the Maze, Ram, RPF and Full-obs ids add,
against the JAX package bit for bit: the maze walk, the Ram burst tape, the
RPF patrol candidates and tape, full observations (centred and not, also
against tests/oracles.py), and Moore (8-action) stepping, mirroring
tests/test_moore.py.

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
from active_tracking_rl_tpu.envs import observe as jobs
from active_tracking_rl_tpu.envs import opponents as jopp
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_torch.envs import env as tenv
from active_tracking_rl_torch.envs import maps as tmaps
from active_tracking_rl_torch.envs import observe as tobs
from active_tracking_rl_torch.envs import opponents as topp
from active_tracking_rl_torch.ops.noise import Threefry
from tests import oracles
from tests.torch_draws import (assert_state_equal, map_draws, nav_draws,
                               ram_draws, reset_draws, torch_cfg)

FAST = dict(nav_goal_candidates=4, flood_iters=96, tape_len=96)

#: the reference's Moore transition table (track_1v1.py:278-279)
REF_TRANSITIONS = {0: [-1, 0], 1: [+1, 0], 2: [0, -1], 3: [0, +1],
                   4: [-1, +1], 5: [+1, +1], 6: [-1, -1], 7: [+1, -1]}


def jcfg(env_id, **kw):
    return dataclasses.replace(jconfig.parse_env_id(env_id), **{**FAST, **kw})


def keys(n, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("level", [0, 1])
def test_maze_map_matches_jax(level):
    cfg = jcfg(f"Track2D-MazePartialNav-v{level}")
    ks = keys(6, 20 + level)
    want = jax.jit(jax.vmap(lambda k: jmaps.generate_map(cfg, k)))(ks)
    draws = map_draws(cfg, ks)
    got = tmaps.generate_map(torch_cfg(cfg), draws)
    assert got.dtype == torch.uint8 and got.shape == (6, 81, 81)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # some walk starts on the border (a reference quirk the port keeps)
    assert ((draws.walk_start == 0) | (draws.walk_start == 40)).any()


@pytest.mark.parametrize("level", [0, 1])
def test_maze_loop_counts_match_jax(level):
    cfg = jcfg(f"Track2D-MazePartialNav-v{level}")
    assert tmaps.maze_loop_bounds(torch_cfg(cfg)) == jmaps.maze_loop_bounds(cfg)
    ks = keys(64, 30)
    want_c, want_d = jax.vmap(
        lambda k: jmaps.maze_complexity_density(cfg, k))(ks)
    u = jax.vmap(jax.random.uniform)(ks)
    got_c, got_d = tmaps.maze_complexity_density(torch_cfg(cfg), t(u))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_maze_walk_from_the_border_picks_among_valid_neighbours():
    """A start on the top border (a reference quirk) has three valid
    neighbours, left, right and down in that order: draw 2 of [0, 3) walks
    down, walling the two cells below the start."""
    cfg = torch_cfg(jcfg("Track2D-MazePartialNav-v1"))
    gen = Threefry().manual_seed(0)
    draws = tmaps.draw_map(cfg, 1, gen, "cpu")
    draws.walk_start[0, 0] = torch.tensor([0, 10])
    draws.walk_pick[0, 0, 0, 1] = 2
    maze = tmaps.generate_maze_map(cfg, draws)
    assert maze[0, 1, 20] == 1 and maze[0, 2, 20] == 1


@pytest.mark.parametrize("moore", [False, True])
def test_ram_tape_matches_jax(moore):
    cfg = jcfg("Track2D-BlockFullRam-v1",
               action_type="Moore" if moore else "VonNeumann", tape_len=200)
    ks = keys(5, 40)
    want = jax.jit(jax.vmap(lambda k: jopp.ram_tape(cfg, k)))(ks)
    got = topp.ram_tape(torch_cfg(cfg), ram_draws(cfg, ks))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.max() == cfg.num_actions - 1


def test_ram_burst_replaces_the_emitted_action():
    """A repeat-burst drawn on a tick is emitted on that very tick."""
    cfg = torch_cfg(jcfg("Track2D-BlockPartialRam-v0", tape_len=4))
    gen = Threefry().manual_seed(0)
    d = topp.draw_ram(cfg, 1, gen, "cpu")
    d.plan0[:] = 1
    d.len0[:] = 1
    d.coin[:] = 0
    d.burst[:] = torch.tensor([[3, 2, 0, 1]], dtype=torch.int8)
    d.length[:] = 1
    assert topp.ram_tape(cfg, d).tolist() == [[3, 2, 0, 1]]


@functools.lru_cache(maxsize=None)
def _rpf_inputs(map_type):
    cfg = jcfg(f"Track2D-{map_type}PartialRPF-v0")
    patrol = jmaps.patrol_goals(cfg)
    mazes = jax.vmap(lambda k: jmaps.carve_patrol(
        jmaps.generate_map(cfg, k), patrol))(keys(3, 50))
    pos, goals = jax.vmap(lambda k, m: jmaps.sample_spawns(cfg, k, m, patrol))(
        keys(3, 51), mazes)
    return cfg, mazes, pos, goals


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("map_type", ["Block", "Maze"])
def test_rpf_candidates_and_tape_match_jax(map_type, backend):
    """Four patrol fields per row (G = 4 to the flood), candidate i reading
    field (1 + i) % 4. JAX floods with its CPU backend; at flood_iters 96, a
    whole number of 16-sweep chunks, the port's relax twin gives the same
    fields."""
    cfg, mazes, pos, goals = _rpf_inputs(map_type)
    ks = keys(3, 52)
    want_c, want_i, want_f = jax.jit(jax.vmap(
        lambda m, g: jopp.nav_candidates(cfg, None, m, g)))(mazes, goals[:, 1])
    want_tape = jax.jit(jax.vmap(
        lambda k, m, s, g: jopp.nav_tape(cfg, k, m, s, g)))(
            ks, mazes, pos[:, 1], goals[:, 1])
    tc = dataclasses.replace(torch_cfg(cfg), flood_backend=backend)
    d = nav_draws(cfg, ks)
    assert d.candidates is None
    got_c, got_i, got_f = topp.nav_candidates(tc, t(mazes), t(goals[:, 1]),
                                              None)
    assert got_f.shape == (3, 4, cfg.maze_size, cfg.maze_size)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i)[0])
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    got_tape = topp.nav_tape(tc, t(mazes), t(pos[:, 1]), t(goals[:, 1]), d)
    np.testing.assert_array_equal(got_tape.numpy(), np.asarray(want_tape))


@pytest.mark.parametrize("mode", ["PZR", "Far", "Adv"])
def test_learned_targets_get_a_zero_tape(mode):
    cfg = torch_cfg(jcfg(f"Track2D-EmptyPartial{mode}-v0"))
    maze = torch.zeros((2, 82, 82), dtype=torch.uint8)
    cell = torch.zeros((2, 2), dtype=torch.int32)
    tape = topp.build_tape(cfg, maze, cell, cell, None, None)
    assert tape.dtype == torch.int8 and tape.shape == (2, cfg.tape_len)
    assert not tape.any()


def _positions(rng, n, s):
    pos = rng.randint(1, s - 1, size=(n, 2, 2)).astype(np.int32)
    pos[0, 1] = pos[0, 0]                       # overlap
    pos[1] = [[1, 1], [s - 2, s - 2]]           # opposite corners
    return pos


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("map_type", ["Block", "Maze"])
def test_full_obs_matches_jax(map_type, center):
    cfg = jcfg(f"Track2D-{map_type}FullPZR-v0", center_full_obs=center)
    s, p, n = cfg.maze_size, cfg.pob_size, 12
    mazes = jax.vmap(lambda k: jmaps.generate_map(cfg, k))(keys(n, 60))
    padded = jnp.pad(mazes, ((0, 0), (p, p), (p, p)), constant_values=1)
    pos = _positions(np.random.RandomState(center), n, s)
    want = jax.jit(jax.vmap(lambda m, q: jobs.observe(cfg, m, q)))(padded, pos)
    got = tobs.observe(torch_cfg(cfg), t(padded), t(pos))
    assert got.dtype == torch.uint8 and got.shape == (n, 2, s, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for row in range(n):
        painted = oracles.full_obs(np.asarray(mazes[row]),
                                   [tuple(q) for q in pos[row]], 0)
        for i in range(2):
            if center:
                shift = (s // 2 - pos[row, i, 0], s // 2 - pos[row, i, 1])
                want_i = np.roll(painted, shift, axis=(0, 1))
                assert got[row, i, s // 2, s // 2] in (2, 4)
            else:
                want_i = painted
            np.testing.assert_array_equal(got[row, i].numpy(), want_i)


def test_moore_deltas_match_reference_table():
    d = topp.deltas(torch.device("cpu")).numpy()
    for a, move in REF_TRANSITIONS.items():
        np.testing.assert_array_equal(d[a], move)


@functools.lru_cache(maxsize=None)
def _jax_step(cfg):
    return jax.jit(JaxEnv(cfg).step_batch)


@pytest.mark.parametrize("env_id", ["Track2D-BlockPartialAdv-v0",
                                    "Track2D-MazeFullRam-v0",
                                    "Track2D-EmptyPartialNav-v0"])
def test_moore_reset_and_step_match_jax(env_id):
    """Moore configs: na = 8 tapes (Ram, Nav) and all 8 moves, diagonal wall
    collisions included, against the JAX package and the NumPy oracle."""
    cfg = jcfg(env_id, action_type="Moore")
    n = 4
    key = jax.random.PRNGKey(70)
    state, obs = jax.jit(lambda k: JaxEnv(cfg).reset_batch(k, n))(key)
    tc = torch_cfg(cfg)
    tstate, tobs_ = tenv.reset(tc, reset_draws(cfg, jax.random.split(key, n)))
    assert_state_equal(tstate, state)
    np.testing.assert_array_equal(tobs_.numpy(), np.asarray(obs))
    if cfg.scripted:
        assert tstate.tape.max() <= 7
    rng = np.random.RandomState(0)
    p = cfg.pob_size
    for _ in range(30):
        a = rng.randint(0, 8, size=(n, 2)).astype(np.int32)
        before = tstate.pos.numpy().copy()
        state, obs, rew, done, _ = _jax_step(cfg)(state, a)
        tstate, tobs_, trew, tdone, _ = tenv.step(tc, tstate, t(a))
        assert_state_equal(tstate, state)
        np.testing.assert_array_equal(tobs_.numpy(), np.asarray(obs))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(rew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(done))
        maze = tstate.maze.numpy()
        for row in range(n):
            acts = [a[row, 0], int(tstate.tape[row, tstate.t[row] - 1])
                    if cfg.scripted else a[row, 1]]
            for i in range(2):
                nxt = before[row, i] + REF_TRANSITIONS[int(acts[i])]
                want = before[row, i] if maze[row, nxt[0] + p, nxt[1] + p] \
                    == 1 else nxt
                np.testing.assert_array_equal(tstate.pos[row, i].numpy(), want)


def test_moore_diagonal_wall_collision():
    """A diagonal into a wall stays and counts a collision, even with both
    cardinal neighbours free: only the destination cell is tested."""
    cfg = torch_cfg(jcfg("Track2D-EmptyPartialAdv-v0", action_type="Moore"))
    gen = Threefry().manual_seed(1)
    state, _ = tenv.reset(cfg, tenv.draw_reset(cfg, 1, gen, "cpu"))
    p = cfg.pob_size
    r, c = (int(x) + p for x in state.pos[0, 0])
    state.maze[0, r - 1, c + 1] = 1
    state.maze[0, r - 1, c] = 0
    state.maze[0, r, c + 1] = 0
    before = state.pos[0, 0].clone()
    state2, *_ = tenv.step(cfg, state, torch.tensor([[4, 0]]))
    assert torch.equal(state2.pos[0, 0], before)
    assert int(state2.c_collision[0, 0]) == 1
