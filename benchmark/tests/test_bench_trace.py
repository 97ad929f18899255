"""The frozen trace reducer on a synthetic trace, and its sweep against
the program's own (``run/profile_summary.py``)."""

import random

import pytest

from benchmark import trace


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


EVENTS = [
    _x("step", "cpu_op", 0, 100),
    _x("aten::conv2d", "cpu_op", 10, 20),
    _x("aten::copy_", "cpu_op", 60, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 11, 2),
    _x("cudaLaunchKernelExC", "cuda_runtime", 15, 2),
    _x("cudaMemsetAsync", "cuda_runtime", 20, 1),
    _x("wgrad2d_grouped_direct_kernel", "kernel", 20, 20),
    _x("cudnn::wgrad_alg1_engine", "kernel", 30, 20),
    _x("flood_bfs_kernel<3>", "kernel", 70, 10),
    _x("Memset (Device)", "gpu_memset", 45, 10),
    _x("ncclDevKernel_AllReduce", "kernel", 80, 5),
    {"ph": "i", "name": "marker", "ts": 3},
]


def test_reduce_events_on_a_synthetic_trace():
    red = trace.reduce_events([dict(e) for e in EVENTS])
    assert red["window_s"] == pytest.approx(100e-6)
    # device busy: [20, 55) and [70, 85)
    assert red["busy_s"] == pytest.approx(50e-6)
    assert red["launches"] == 2
    assert trace.kernel_union_s(red, "wgrad") == pytest.approx(30e-6)
    assert trace.kernel_union_s(red, "FLOOD") == pytest.approx(10e-6)
    assert trace.kernel_union_s(red, "nccl") == pytest.approx(5e-6)
    assert red["kernels"]["flood_bfs_kernel<3>"] == {"s": 10e-6, "count": 1}
    assert red["device_ops"][0] == ["wgrad2d_grouped_direct_kernel", 20e-6]
    # gaps: [0, 20) mid 10 in aten::conv2d (started at 10); [55, 70) mid
    # 62.5 in aten::copy_; [85, 100) mid 92.5 in step
    gaps = dict(red["idle_gaps"])
    assert gaps == pytest.approx({"aten::conv2d": 20e-6,
                                  "aten::copy_": 15e-6, "step": 15e-6})


def test_idle_gaps_outside_any_cpu_op():
    gaps = trace.idle_gaps([(10.0, 20.0)], 0.0, 30.0, [])
    assert gaps == pytest.approx({"(no cpu_op)": 20e-6})


def test_sweep_equals_the_programs():
    from active_tracking_rl_torch.run.profile_summary import _sweep
    rng = random.Random(3)
    for _ in range(20):
        iv = []
        for _ in range(50):
            a = rng.uniform(0, 100)
            iv.append((a, a + rng.uniform(0, 10), rng.randrange(3)))
        assert trace.sweep(iv, 3) == _sweep(iv, 3)
        union = trace.merged([(a, b) for a, b, _ in iv])
        assert sum(b - a for a, b in union) == pytest.approx(
            sum(trace.sweep(iv, 3)))


def test_idle_share_takes_the_untraced_iteration():
    """The card's busy time an iteration over the untraced window's time an
    iteration: the profiler's cost on the host does not count as idle."""
    from benchmark import harness
    reader = harness.load_reader(harness.HERE, "device.idle_share")
    red = trace.reduce_events([dict(e) for e in EVENTS])
    run = harness.Run({}, {}, "card", None, 1.0, iters=4, window_s=400e-6,
                      rate=1.0, trace=red, traced_iters=1)
    # 50 us busy in a traced iteration, 100 us an untraced one
    assert reader.read(run) == pytest.approx(50.0)
    assert reader.read(harness.Run({}, {}, "card", None, 1.0, 4, 400e-6,
                                   1.0)) is None
