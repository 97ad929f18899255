"""Seconds from the process's start to the timed window: imports, the
card's start, the kernel build where it runs, the learner built from the
seed, and the checked first steps, which warm every shape of the cell."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
