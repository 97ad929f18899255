"""The share of an iteration in which no kernel, memcpy or memset ran on
the card, in percent: the card's busy time an iteration, from a trace of
the card's activity alone, over the untraced window's time an iteration.
The untraced window sets the iteration's length because the profiler's
own work on the host lengthens the traced iterations."""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "env_steps_per_s"


def read(run):
    if not run.trace or not run.traced_iters or not run.iters:
        return None
    busy = run.trace["busy_s"] / run.traced_iters
    return 100.0 * (1.0 - busy / (run.window_s / run.iters))
