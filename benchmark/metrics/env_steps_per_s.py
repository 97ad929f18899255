"""Envs x rollout steps x iterations over the window's seconds, on one
card: all the work and all the time of the window, pool refreshes
included."""

UNIT = "env-steps/s"
SOURCE = "host_clock"


def read(run):
    return run.rate
