"""The BFS flood kernel against its roofline, in percent: each launch's
bytes (``flops.flood_bytes`` at the pool's rows, the navigator's
goal candidates and the map's side) over the memory bandwidth, over the
device time of the kernels whose names hold ``KERNEL_SUBSTRING``. Every
launch in the window floods one pool."""

from benchmark import flops, trace

UNIT = "%"
SOURCE = "device_trace"
LAYER = "ops/flood.py + csrc/flood_bfs.cu"
MOVES = "env_steps_per_s"
KERNEL_SUBSTRING = "flood"


def read(run):
    if not run.trace or not run.peaks:
        return None
    launches = sum(v["count"] for n, v in run.trace["kernels"].items()
                   if KERNEL_SUBSTRING in n.lower())
    spent = trace.kernel_union_s(run.trace, KERNEL_SUBSTRING)
    if not launches or spent <= 0:
        return None
    each = flops.flood_bytes(run.traffic["reset_pool"],
                             run.cfg["nav_goal_candidates"],
                             run.cfg["maze_size"])
    return 100.0 * launches * each / run.peaks["hbm_bytes_per_s"] / spent
