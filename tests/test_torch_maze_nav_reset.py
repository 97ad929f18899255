"""One Track2D-MazePartialNav-v0 reset at the shipped sizes (16 goal
candidates, flood_iters 256, a 512-tick tape), the port against the JAX
package, bit for bit, on 2 rows.

The port runs `flood_backend="pallas"`, whose flood on the CPU is the relax
twin (ops/flood.py:flood_fields_relax_plain), the maze-main path's variant.
JAX runs its CPU default, the capped relaxation `distance_fields`: at iters
256, a whole number of 16-sweep chunks, both are the BFS capped at 256. The
other parity tests cut these sizes (tests/test_torch_env_ids.py: 4
candidates, iters 96, tape 96); this file holds the shipped ones, alone so
that its JAX compile runs on a worker of its own.
"""

import dataclasses

import jax
import numpy as np

from active_tracking_rl_tpu import config as jconfig
from active_tracking_rl_tpu.envs.env import TrackEnv as JaxEnv
from active_tracking_rl_torch.envs import env as tenv
from tests.torch_draws import assert_state_equal, batch_draws, torch_cfg

ENV_ID = "Track2D-MazePartialNav-v0"


def test_maze_nav_reset_at_shipped_sizes_matches_jax():
    cfg = jconfig.parse_env_id(ENV_ID)
    assert (cfg.nav_goal_candidates, cfg.flood_iters, cfg.tape_len) == (
        16, 256, 512)
    n, key = 2, jax.random.PRNGKey(11)
    env = JaxEnv(cfg)
    state, obs = jax.jit(lambda k: env.reset_batch(k, n))(key)
    tc = dataclasses.replace(torch_cfg(cfg), flood_backend="pallas")
    tstate, tobs = tenv.reset(tc, batch_draws(cfg, key, n))
    assert_state_equal(tstate, state)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
    # the navigator walked: its tape is not all one action
    assert len(np.unique(np.asarray(state.tape))) > 1
