"""Static train mode 2 (alternating) against the JAX package: three train
steps of maze-lstm on Track2D-BlockPartialNav-v0 with TrainConfig.train_mode
2, at loss modes 0, 1, 0 as the alternation picks them, from the same
params, carry, reset pool and noise (tests/torch_learner_pair.py:run_steps).

Tolerances are the learner tests' (tests/test_torch_learner.py): integer
paths bit for bit; loss, metrics and gradients rtol 1e-4 / atol 1e-5;
updated params rtol 1e-5 / atol 1e-6. At each mode only that player's
gradients are non-zero, in both packages.
"""

import pytest

from active_tracking_rl_torch.models.dueling import params_from_flax
from tests.torch_learner_pair import assert_pair_close, run_steps

PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MODES = (0, 1, 0)


@pytest.fixture(scope="module")
def runs():
    return run_steps("Track2D-BlockPartialNav-v0", "maze-lstm", MODES,
                     train_mode=2, aux="none")


@pytest.mark.parametrize("i", range(len(MODES)))
def test_mode2_step_matches_jax(runs, i):
    assert_pair_close(runs[i], PARAM_TOL)


@pytest.mark.parametrize("i", range(len(MODES)))
def test_mode2_trains_one_player_a_step(runs, i):
    grads = params_from_flax(runs[i]["jax"][1])
    tgrads = runs[i]["torch"][1]
    held = "player1" if MODES[i] == 0 else "player0"
    for name, g in grads.items():
        if name.startswith(held):
            assert not g.any() and not tgrads[name].any(), name
        else:
            assert tgrads[name].shape == g.shape
    assert any(g.any() for n, g in grads.items() if not n.startswith(held))
