"""Static train mode 1 against the JAX package: two train steps of
tat-maze-lstm on Track2D-BlockPartialPZR-v0 with TrainConfig.train_mode 1,
both at loss mode 1 (the target learns, the tracker is held), from the same
params, carry, reset pool and noise (tests/torch_learner_pair.py:run_steps).

Tolerances are the learner tests' (tests/test_torch_learner.py): integer
paths bit for bit; loss, metrics and gradients rtol 1e-4 / atol 1e-5;
updated params rtol 1e-5 / atol 1e-6. The tracker's gradients are zero in
both packages and its parameters do not move.
"""

import numpy as np
import pytest

from active_tracking_rl_torch.models.dueling import params_from_flax
from tests.torch_learner_pair import assert_pair_close, run_steps

PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MODES = (1, 1)


@pytest.fixture(scope="module")
def runs():
    return run_steps("Track2D-BlockPartialPZR-v0", "tat-maze-lstm", MODES,
                     train_mode=1)


@pytest.mark.parametrize("i", range(len(MODES)))
def test_mode1_step_matches_jax(runs, i):
    assert_pair_close(runs[i], PARAM_TOL)


def test_mode1_holds_the_tracker(runs):
    start = runs[0]["torch"][0]
    for run in runs:
        grads = params_from_flax(run["jax"][1])
        tgrads = run["torch"][1]
        for name, g in grads.items():
            if name.startswith("player0"):
                assert not g.any() and not tgrads[name].any(), name
        assert any(g.any() for n, g in grads.items()
                   if n.startswith("player1"))
    for name, w in runs[-1]["torch"][0].items():
        if name.startswith("player0"):
            np.testing.assert_array_equal(w.numpy(), start[name].numpy())
