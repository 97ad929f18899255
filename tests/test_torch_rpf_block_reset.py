"""Track2D-BlockPartialRPF-v0 resets at the shipped sizes (16 goal
candidates, flood_iters 256, a 512-tick patrol tape), the port against the
JAX package, bit for bit, on 2 rows from each of two keys (80 and 3).

RPF carves the four patrol corners into the map, floods one field per
corner and cycles the candidates through them from corner 1. The other
parity tests cut these sizes (tests/test_torch_env_ids.py: 4 candidates,
iters 96, tape 96); this file holds the shipped ones, alone so that its
JAX compile runs on a worker of its own.
"""

import functools

import jax
import numpy as np
import pytest

from active_tracking_rl_tpu import config as jconfig
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_torch.envs import env as tenv
from tests.torch_draws import assert_state_equal, batch_draws, torch_cfg

ENV_ID = "Track2D-BlockPartialRPF-v0"
N = 2


@functools.lru_cache(maxsize=None)
def _jax_reset():
    return jax.jit(lambda k: JaxEnv(jconfig.parse_env_id(ENV_ID))
                   .reset_batch(k, N))


@pytest.mark.parametrize("seed", [80, 3])
def test_rpf_reset_at_shipped_sizes_matches_jax(seed):
    cfg = jconfig.parse_env_id(ENV_ID)
    assert (cfg.nav_goal_candidates, cfg.flood_iters, cfg.tape_len) == (
        16, 256, 512)
    key = jax.random.PRNGKey(seed)
    state, obs = _jax_reset()(key)
    tstate, tobs = tenv.reset(torch_cfg(cfg), batch_draws(cfg, key, N))
    assert_state_equal(tstate, state)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
    # the patrol walked: its tape is not all one action
    assert len(np.unique(np.asarray(state.tape))) > 1
