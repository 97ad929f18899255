"""One train step of the port against the JAX package's ``make_train_step``
for the networks and optimizer that the earlier learner tests do not run:
maze-gru with SharedRMSprop on Track2D-BlockPartialNav-v0, and icml-lstm on
Full obs (Track2D-BlockFullNav-v0), both at train mode 0 from the same
params, carry, reset pool and noise (tests/torch_learner_pair.py).

Integer paths (env state, frame stack, pool pointer, episode lengths)
match bit for bit. Loss, metrics and gradients: rtol 1e-4 / atol 1e-5, as
in tests/test_torch_learner.py (float32 on both sides; the reductions
associate differently in XLA and PyTorch, amplified by the 8-step BPTT
chain). Updated params: rtol 1e-5 / atol 1e-6, as there, after SharedAdam
and after SharedRMSprop alike.
"""

import pytest

from tests.torch_learner_pair import assert_pair_close, run_pair

PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
CASES = {
    "maze-gru-rmsprop": dict(env_id="Track2D-BlockPartialNav-v0",
                             network="maze-gru", optimizer="RMSprop",
                             aux="none"),
    "icml-lstm-full": dict(env_id="Track2D-BlockFullNav-v0",
                           network="icml-lstm", aux="none"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case):
    assert_pair_close(run_pair(**CASES[case]), PARAM_TOL)
