"""Milliseconds in which a kernel, memcpy or memset ran on the card, an
iteration: the card's busy time in a trace of its activity alone over the
traced iterations. The card's work alone, so it does not move with the
host's pace, which spreads the window's rate from run to run."""

UNIT = "ms/iter"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "env_steps_per_s"


def read(run):
    if not run.trace or not run.traced_iters or not run.trace["busy_s"]:
        return None
    return 1e3 * run.trace["busy_s"] / run.traced_iters
