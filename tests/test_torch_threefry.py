"""The port's generator (``ops/noise.py``) against ``jax.random``.

``Threefry`` is threefry2x32 in plain torch integer ops. Here it is held
bit for bit to ``jax.extend.random.threefry_2x32`` and, for raw
``uint32[2]`` keys, to ``jax.random.bits``, ``uniform``, ``split`` and
``fold_in`` (partitionable threefry, JAX's default); its Gumbel and normal
noise to ``jax.random.gumbel`` and ``normal`` within the two libraries'
``log`` and ``erfinv`` (stated per case). Then its own contract: a draw
takes the next counters (two draws equal one of their summed size), the
state repeats a stream, and a data-parallel rank's block is those rows of
the global draw, down to the env's reset and the step's noise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32 as jax_threefry

from active_tracking_rl_torch.config import parse_env_id
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.rl.learner import draw_step_noise
from active_tracking_rl_torch.run.train import iteration_generator

torch.set_num_threads(1)

SHAPES = [(1,), (7,), (3, 5), (2, 3, 5), (1001,), (4, 0, 3)]
SEEDS = [0, 1, 12345, 2 ** 31 - 1]
_RNG = np.random.default_rng(20261018)
RAW_KEYS = [tuple(int(v) for v in _RNG.integers(0, 2 ** 32, 2))
            for _ in range(3)]


def _jkey(key):
    return jnp.array(key, dtype=jnp.uint32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_threefry_known_answer():
    """Key (0, 0), counter (0, 0): 0x6b200159, 0x99ba4efe."""
    y0, y1 = noise.threefry_2x32((0, 0), torch.tensor([0]), torch.tensor([0]))
    assert (int(y0), int(y1)) == (0x6B200159, 0x99BA4EFE)
    assert np.asarray(jax_threefry(_jkey((0, 0)), jnp.zeros(2, jnp.uint32))
                      ).tolist() == [1797259609, 2579123966]


@pytest.mark.parametrize("key", [(0, 0)] + RAW_KEYS)
def test_threefry_matches_jax(key):
    """Random counters, including the words' extremes."""
    rng = np.random.default_rng(key[0] & 0xFFFF)
    c = rng.integers(0, 2 ** 32, (2, 37), dtype=np.uint64)
    c[:, :2] = [[0, 2 ** 32 - 1], [2 ** 32 - 1, 0]]
    want = np.asarray(jax_threefry(_jkey(key), jnp.asarray(
        c.reshape(-1).astype(np.uint32))))
    y0, y1 = noise.threefry_2x32(key, torch.from_numpy(c[0].astype(np.int64)),
                                 torch.from_numpy(c[1].astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([_u32(y0), _u32(y1)]), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        _u32(noise.bits(shape, noise.generator(seed))),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    for low, high in ((0.0, 1.0), (-0.0883, 0.0883), (0.5, 2.0)):
        np.testing.assert_array_equal(
            noise.uniform(shape, noise.generator(seed), low=low,
                          high=high).numpy(),
            np.asarray(jax.random.uniform(key, shape, minval=low,
                                          maxval=high)))


@pytest.mark.parametrize("key", RAW_KEYS)
def test_raw_key_draws_split_fold_in_match_jax(key):
    gen = noise.Threefry(key=key)
    np.testing.assert_array_equal(
        _u32(noise.bits((5, 9), gen)),
        np.asarray(jax.random.bits(_jkey(key), (5, 9), jnp.uint32)))
    for num in (1, 2, 3, 7):
        np.testing.assert_array_equal(
            np.array(noise.split(key, num), np.uint32),
            np.asarray(jax.random.split(_jkey(key), num)))
    for data in (0, 1, 17, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            np.array(noise.fold_in(key, data), np.uint32),
            np.asarray(jax.random.fold_in(_jkey(key), data)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_normal_near_jax(seed):
    """The uniforms are equal bit for bit; Gumbel within 5e-7 (the two
    libraries' logs differ in the last ulp, and the outer log's argument
    sits near 1 at Gumbel values near 0), normal within 5e-5 (XLA's and
    torch's erfinv are different approximations)."""
    key = jax.random.PRNGKey(seed)
    g = noise.gumbel((50, 41), noise.generator(seed)).numpy()
    np.testing.assert_allclose(g, np.asarray(jax.random.gumbel(key, (50, 41))),
                               rtol=0, atol=5e-7)
    z = noise.normal((50, 41), noise.generator(seed)).numpy()
    np.testing.assert_allclose(z, np.asarray(jax.random.normal(key, (50, 41))),
                               rtol=0, atol=5e-5)
    assert np.isfinite(g).all() and np.isfinite(z).all()


def test_consecutive_draws_equal_one_draw():
    """Each draw takes the next counters: no counter is used twice."""
    gen = noise.generator(7)
    parts = [noise.bits((3, 4), gen), noise.bits((5,), gen),
             noise.bits((2, 2, 2), gen)]
    assert gen.counter == 12 + 5 + 8
    whole = noise.bits((25,), noise.generator(7))
    np.testing.assert_array_equal(
        torch.cat([p.reshape(-1) for p in parts]).numpy(), whole.numpy())
    a = noise.generator(7)
    u = torch.cat([noise.uniform((10,), a), noise.uniform((15,), a)])
    np.testing.assert_array_equal(u.numpy(),
                                  noise.uniform((25,), noise.generator(7)))


def test_state_repeats_a_stream():
    gen = noise.generator(3)
    noise.gumbel((4, 6), gen)
    state = gen.get_state()
    assert state.dtype == torch.int64 and state.device.type == "cpu"
    first = [noise.bits((9,), gen), noise.randint(5, (3, 3), gen),
             noise.permutations(2, 11, gen)]
    other = noise.Threefry().set_state(state)
    again = [noise.bits((9,), other), noise.randint(5, (3, 3), other),
             noise.permutations(2, 11, other)]
    for x, y in zip(first, again):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert gen.get_state().tolist() == other.get_state().tolist()
    assert gen.manual_seed(3).get_state().tolist() == [0, 3, 0]


@pytest.mark.parametrize("dim,rows", [(0, (2, 5)), (0, (0, 7)), (1, (1, 3)),
                                      (2, (0, 4)), (1, (3, 3))])
def test_block_is_rows_of_global_draw(dim, rows):
    """A data-parallel rank's block: rows lo..hi-1 along `dim` of the global
    draw, the generator advancing as for the global draw."""
    shape = (7, 4, 6)
    whole = noise.gumbel(shape, noise.generator(11))
    gen = noise.generator(11)
    block = noise.gumbel(shape, gen, rows=rows, dim=dim)
    np.testing.assert_array_equal(
        block.numpy(), whole.narrow(dim, rows[0], rows[1] - rows[0]).numpy())
    assert gen.counter == 7 * 4 * 6


def test_rank_blocks_of_reset_and_step_noise():
    """Every rank's reset rows and step noise are its rows of the global
    ones, and its generator ends where the global one does."""
    cfg = parse_env_id("Track2D-BlockPartialRam-v0")
    env = TrackEnv(cfg, "cpu")
    ga = noise.generator(4)
    full, full_obs = env.reset_batch(6, ga)
    chunked, chunked_obs = env.reset_batch_chunked(6, ga, 4)   # 2 groups
    fnoise = draw_step_noise(3, 6, cfg.num_actions, ga, "cpu")
    for lo, hi in ((0, 2), (2, 4), (4, 6)):
        gb = noise.generator(4)
        part, part_obs = env.reset_batch(6, gb, (lo, hi))
        cpart, cpart_obs = env.reset_batch_chunked(6, gb, 4, (lo, hi))
        pnoise = draw_step_noise(3, 6, cfg.num_actions, gb, "cpu", (lo, hi))
        assert gb.counter == ga.counter
        for got, want in ((part_obs, full_obs), (part.pos, full.pos),
                          (cpart_obs, chunked_obs), (cpart.pos, chunked.pos),
                          (pnoise.bootstrap, fnoise.bootstrap)):
            np.testing.assert_array_equal(got.numpy(), want[lo:hi].numpy())
        np.testing.assert_array_equal(pnoise.actions.numpy(),
                                      fnoise.actions[:, lo:hi].numpy())


def test_randint_and_permutations_are_in_law():
    gen = noise.generator(9)
    r = noise.randint(6, (20000,), gen, dtype=torch.int8)
    assert r.dtype == torch.int8 and 0 <= int(r.min()) and int(r.max()) == 5
    counts = np.bincount(r.numpy(), minlength=6)
    assert np.abs(counts / 20000 - 1 / 6).max() < 0.015
    p = noise.permutations(50, 13, gen)
    np.testing.assert_array_equal(np.sort(p.numpy(), -1),
                                  np.tile(np.arange(13), (50, 1)))


def test_iteration_generator_folds_the_iteration_in():
    """The trainer's pool and eval generators: the key of the base seed
    folded with the iteration (jax.random.fold_in)."""
    for base, it in ((777 + 1, 1), (999 + 3, 400)):
        gen = iteration_generator(base, it, "cpu")
        want = jax.random.bits(jax.random.fold_in(jax.random.PRNGKey(base),
                                                  it), (33,), jnp.uint32)
        np.testing.assert_array_equal(_u32(noise.bits((33,), gen)),
                                      np.asarray(want))
