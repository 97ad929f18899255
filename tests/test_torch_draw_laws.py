"""The port's own random draws held to the JAX package's distributions.

Every other port test feeds JAX's draws at the seam (tests/torch_draws.py),
so none of them shows that what the port draws from its generator
(``ops/noise.py``'s threefry2x32) in production follows the laws that ``jax.random`` follows. Here both
packages draw from their own generators at the sizes of the Nav recipes
(Track2D-BlockPartialNav-v0: 16 goal candidates, 256 flood iterations,
tapes of 512 ticks) and two-sample tests compare the results, with the KS
and chi-square helpers of tests/test_distributions.py (copied, without
JAX, into tests/torch_stats.py; alpha ~1e-3):

  * the Block map's interior wall fraction (KS, one value a map);
  * the target's spawn offset from the tracker (chi-square over the 3 x 3
    window's cells, one offset a reset);
  * the Nav tape's actions (KS on each row's share of each action: the
    ticks of one tape are not independent, its rows are);
  * the actions that ``models/heads.py:sample_discrete`` samples with
    ``ops/noise.py:gumbel`` at saturated logits (gaps of 4 to 12 from the
    top logit, the regime of a collapsed tracker), against
    ``jax.random.categorical`` (chi-square over the actions).

``test_draw_law_checks_can_fail`` shows that these sample sizes refuse a
skewed draw: Gumbel noise shifted by 0.05 on one action, and wall
fractions scaled by 1.15.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from active_tracking_rl_tpu.config import parse_env_id as jparse
from active_tracking_rl_tpu.envs import maps as jmaps
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_torch.config import parse_env_id
from active_tracking_rl_torch.envs import maps
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.heads import sample_discrete
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.ops.noise import Threefry
from tests.torch_stats import (OFFSET_CATS, chi2_2samp_ok, counts,
                               ks_2samp_ok)

torch.set_num_threads(1)

ENV_ID = "Track2D-BlockPartialNav-v0"
MAPS = 1024          # maps and spawns a side
TAPES = 64           # Nav tapes a side (a full-size tape takes ~0.25 s here)
SAMPLES = 1 << 22    # actions a side at each set of logits
#: logits with gaps of 4 to 12 from the top one
SATURATED = [(0.0, -4.0, -8.0, -12.0), (0.0, -6.0, -10.0, -10.0)]


def _port_maps(n: int, seed: int) -> np.ndarray:
    cfg = parse_env_id(ENV_ID)
    gen = Threefry().manual_seed(seed)
    return maps.generate_map(cfg, maps.draw_map(cfg, n, gen, "cpu")).numpy()


def _jax_maps(n: int, seed: int) -> np.ndarray:
    cfg = jparse(ENV_ID)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.asarray(jax.vmap(lambda k: jmaps.generate_map(cfg, k))(keys))


def _wall_fraction(mazes: np.ndarray) -> np.ndarray:
    return mazes[:, 1:-1, 1:-1].mean(axis=(1, 2))


def _port_offsets(n: int, seed: int):
    cfg = parse_env_id(ENV_ID)
    gen = Threefry().manual_seed(seed)
    maze = maps.generate_map(cfg, maps.draw_map(cfg, n, gen, "cpu"))
    pos, _ = maps.sample_spawns(cfg, maze, maps.draw_spawns(cfg, n, gen, "cpu"))
    return [tuple(o) for o in (pos[:, 1] - pos[:, 0]).tolist()]


def _jax_offsets(n: int, seed: int):
    cfg = jparse(ENV_ID)

    def one(key):
        k_map, k_spawn = jax.random.split(key)
        maze = jmaps.generate_map(cfg, k_map)
        return jmaps.sample_spawns(cfg, k_spawn, maze)[0]

    pos = np.asarray(jax.jit(jax.vmap(one))(
        jax.random.split(jax.random.PRNGKey(seed), n)))
    return [tuple(o) for o in (pos[:, 1] - pos[:, 0]).tolist()]


def _action_shares(tapes: np.ndarray, num_actions: int) -> np.ndarray:
    """(rows, A): each tape's share of each action."""
    return np.stack([(tapes == a).mean(1) for a in range(num_actions)], 1)


def _port_actions(logits, n: int, seed: int, shift: float = 0.0):
    """Actions of sample_discrete under the production Gumbel noise; `shift`
    adds to the second action's noise (a skewed draw)."""
    gen = Threefry().manual_seed(seed)
    a = len(logits)
    g = noise.gumbel((n, a), gen, "cpu")
    g[:, 1] += shift
    x = torch.tensor(logits, dtype=torch.float32).expand(n, a)
    return torch.bincount(sample_discrete(x, g).action, minlength=a).numpy()


def _jax_actions(logits, n: int, seed: int):
    acts = jax.random.categorical(jax.random.PRNGKey(seed),
                                  np.asarray(logits, np.float32), shape=(n,))
    return np.bincount(np.asarray(acts), minlength=len(logits))


def test_block_wall_fraction_law():
    ok, d, crit = ks_2samp_ok(_wall_fraction(_port_maps(MAPS, 1)),
                               _wall_fraction(_jax_maps(MAPS, 1)))
    assert ok, f"wall fraction KS D={d:.4f} > {crit:.4f}"


def test_spawn_offset_law():
    pc, p_other = counts(_port_offsets(MAPS, 2), OFFSET_CATS)
    jc, j_other = counts(_jax_offsets(MAPS, 2), OFFSET_CATS)
    assert p_other == 0 and j_other == 0, (p_other, j_other)
    ok, stat, crit = chi2_2samp_ok(pc, jc)
    assert ok, f"spawn offset chi2 {stat:.1f} > {crit:.1f} ({pc} vs {jc})"


def test_nav_tape_action_law():
    jcfg = jparse(ENV_ID)
    assert (jcfg.nav_goal_candidates, jcfg.flood_iters, jcfg.tape_len) == (
        16, 256, 512)                    # the recipe's sizes
    jstate, _ = jax.jit(lambda k: JaxEnv(jcfg).reset_batch(k, TAPES))(
        jax.random.PRNGKey(3))
    state, _ = TrackEnv(parse_env_id(ENV_ID), "cpu").reset_batch(
        TAPES, Threefry().manual_seed(3))
    a = jcfg.num_actions
    mine = _action_shares(state.tape.numpy(), a)
    theirs = _action_shares(np.asarray(jstate.tape), a)
    for action in range(a):
        ok, d, crit = ks_2samp_ok(mine[:, action], theirs[:, action])
        assert ok, f"action {action} share KS D={d:.4f} > {crit:.4f}"


@pytest.mark.parametrize("logits", SATURATED)
def test_sample_discrete_law_at_saturated_logits(logits):
    mine = _port_actions(logits, SAMPLES, 4)
    theirs = _jax_actions(logits, SAMPLES, 4)
    assert mine.min() >= 20 and theirs.min() >= 20   # every action drawn
    ok, stat, crit = chi2_2samp_ok(mine, theirs)
    assert ok, f"action chi2 {stat:.1f} > {crit:.1f} ({mine} vs {theirs})"


def test_draw_law_checks_can_fail():
    """A Gumbel draw shifted by 0.05 on one action, and wall fractions 15%
    too high, are refused at these sample sizes; the unshifted draw of
    another seed is not."""
    logits = SATURATED[0]
    theirs = _jax_actions(logits, SAMPLES, 4)
    assert chi2_2samp_ok(_port_actions(logits, SAMPLES, 5), theirs)[0]
    assert not chi2_2samp_ok(_port_actions(logits, SAMPLES, 5, shift=0.05),
                              theirs)[0]
    walls = _wall_fraction(_jax_maps(MAPS, 1))
    assert ks_2samp_ok(_wall_fraction(_port_maps(MAPS, 6)), walls)[0]
    assert not ks_2samp_ok(1.15 * _wall_fraction(_port_maps(MAPS, 6)),
                            walls)[0]

