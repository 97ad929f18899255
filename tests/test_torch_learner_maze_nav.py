"""maze-main's config against the JAX package: two train steps of
maze-lstm on Track2D-MazePartialNav-v0 (the maze walk's maps, the Nav
tapes' floods) at train mode 0, from the same params, carry, reset pool
and noise (tests/torch_learner_pair.py:run_steps), with the learner tests'
tolerances: integer paths bit for bit; loss, metrics and gradients rtol
1e-4 / atol 1e-5; updated params rtol 1e-5 / atol 1e-6.
"""

import pytest

from tests.torch_learner_pair import assert_pair_close, run_steps

PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MODES = (0, 0)


@pytest.fixture(scope="module")
def runs():
    return run_steps("Track2D-MazePartialNav-v0", "maze-lstm", MODES,
                     aux="none")


@pytest.mark.parametrize("i", range(len(MODES)))
def test_maze_nav_step_matches_jax(runs, i):
    assert_pair_close(runs[i], PARAM_TOL)
