"""Kernel launches the host made in an iteration: the ``cudaLaunchKernel``
runtime calls of the traced iterations over their count. The rollout and
the learner launch every op one by one, so the count says how much host
work paces the step."""

UNIT = "launches/iter"
SOURCE = "device_trace"
LAYER = "rl/ host dispatch (learner, rollout)"
MOVES = "env_steps_per_s"


def read(run):
    if not run.trace or not run.traced_iters or not run.trace["launches"]:
        return None
    return run.trace["launches"] / run.traced_iters
