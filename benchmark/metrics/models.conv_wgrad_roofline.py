"""The encoders' weight gradients against their roofline, in percent: the
least time they need (each trained convolution's operations over the
float32 peak or its bytes over the memory bandwidth, whichever is larger,
``flops.wgrad_counts``), summed over the traced iterations, over the
device time of the kernels whose names hold ``KERNEL_SUBSTRING``. A kernel
that takes their place is read only if its name holds it too."""

from benchmark import flops, trace

UNIT = "%"
SOURCE = "device_trace"
LAYER = "models/ encoder convolutions"
MOVES = "env_steps_per_s"
KERNEL_SUBSTRING = "wgrad"


def read(run):
    if not run.trace or not run.peaks:
        return None
    spent = trace.kernel_union_s(run.trace, KERNEL_SUBSTRING)
    if spent <= 0:
        return None
    pk = run.peaks
    least = sum(max(c["flops"] / pk["fp32_flops_per_s"],
                    c["bytes"] / pk["hbm_bytes_per_s"])
                for c in flops.wgrad_counts(run.cfg, run.traffic))
    return 100.0 * least * run.traced_iters / spent
