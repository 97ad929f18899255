"""``run/profile_summary.py``, the port's counterpart of the JAX package's
``run/xprof_summary.py``: a hand-made Chrome trace with known overlaps
gives exact device shares and idle time; nested CPU ops are timed by their
self time; a trace that ``run/train.py --profile-dir`` writes on the CPU,
and one that ``--capture`` writes there, with remat on and off, summarise
(shares sum to 1).
"""

import functools
import json

import pytest

import active_tracking_rl_torch.run.train as train_mod
import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_torch.run import profile_summary as ps
from active_tracking_rl_torch.utils.logging import MetricWriter


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_device_shares_and_idle_are_exact(tmp_path):
    events = [
        _x("PyTorch Profiler (0)", "Trace", 0.0, 50.0),
        _x("aten::mm", "cpu_op", 1.0, 3.0),
        _x("gemm", "kernel", 0.0, 10.0, tid=7),
        _x("gemm", "kernel", 5.0, 10.0, tid=8),        # overlaps the first
        _x("Memcpy HtoD", "gpu_memcpy", 12.0, 8.0, tid=9),
        _x("Memset", "gpu_memset", 30.0, 5.0, tid=7),
        _x("reduce", "kernel", 40.0, 2.0, tid=7),
        {"ph": "i", "name": "Record Window End", "ts": 99.0},
        {"ph": "M", "name": "process_name", "ts": 0, "pid": 1},
    ]
    (tmp_path / "trace.json").write_text(json.dumps(
        {"traceEvents": events}))
    s = ps.summarize_trace(str(tmp_path))
    assert s["mode"] == "device"
    # window [0, 50); kernel [0, 15) + [40, 42), memcpy [15, 20), memset 5
    assert s["window_ms"] == pytest.approx(0.050)
    assert s["busy_ms"] == pytest.approx(0.027)
    assert s["total_device_ms"] == pytest.approx(0.035)
    assert s["categories"] == pytest.approx(
        {"kernel": 17 / 50, "memcpy": 5 / 50, "memset": 5 / 50,
         "idle": 23 / 50})
    assert sum(s["categories"].values()) == pytest.approx(1.0)
    top = {o["name"]: o for o in s["top_ops"]}
    assert top["gemm"]["count"] == 2
    assert top["gemm"]["ms"] == pytest.approx(0.020)
    assert top["gemm"]["share"] == pytest.approx(20 / 35)
    assert top["Memcpy HtoD"]["category"] == "memcpy"
    assert s["top_ops"][0]["name"] == "gemm"


def test_cpu_ops_are_timed_by_self_time():
    events = [
        _x("aten::linear", "cpu_op", 0.0, 10.0),
        _x("aten::t", "cpu_op", 1.0, 2.0),
        _x("aten::addmm", "cpu_op", 4.0, 5.0),
        _x("aten::copy_", "cpu_op", 5.0, 1.0),          # inside addmm
        _x("aten::relu", "cpu_op", 20.0, 4.0, tid=2),
    ]
    s = ps.summarize_events(events)
    assert s["mode"] == "cpu"
    times = {o["name"]: o["ms"] for o in s["top_ops"]}
    assert times == pytest.approx({"aten::linear": 0.003, "aten::t": 0.002,
                                   "aten::addmm": 0.004, "aten::copy_": 0.001,
                                   "aten::relu": 0.004})
    assert s["total_cpu_ms"] == pytest.approx(0.014)
    assert s["categories"] == pytest.approx({"cpu_op": 14 / 24,
                                             "idle": 10 / 24})


def _check_summary(s):
    assert s["mode"] == "cpu" and s["op_events"] > 100
    assert sum(s["categories"].values()) == pytest.approx(1.0, abs=1e-9)
    assert 0 < s["categories"]["cpu_op"] <= 1
    assert s["top_ops"] and all(o["ms"] > 0 and o["count"] >= 1
                                for o in s["top_ops"])
    assert s["top_ops"][0]["ms"] >= s["top_ops"][-1]["ms"]


def test_trainer_profile_dir_trace_summarises(tmp_path, monkeypatch):
    monkeypatch.setattr(train_mod, "MetricWriter",
                        functools.partial(MetricWriter,
                                          use_tensorboard=False))
    env = "Track2D-BlockPartialRam-v0"
    train_mod.main(["--device", "cpu", "--env", env, "--env-base", env,
                    "--num-envs", "4", "--reset-pool", "4",
                    "--num-steps", "2", "--test-eps", "2",
                    "--total-iters", "15", "--checkpoint-every", "1000",
                    "--log-dir", str(tmp_path),
                    "--profile-dir", str(tmp_path / "prof")])
    s = ps.main(["--trace-dir", str(tmp_path / "prof"), "--top", "5"])
    _check_summary(s)
    assert len(s["top_ops"]) == 5


def test_capture_on_the_cpu_summarises(tmp_path):
    s = ps.main(["--capture", "--device", "cpu", "--num-envs", "8",
                 "--iters", "2", "--env", "Track2D-EmptyPartialRam-v0",
                 "--trace-dir", str(tmp_path / "cap")])
    _check_summary(s)
    assert s["trace"].endswith("trace.json")


def test_capture_without_remat_on_the_cpu_summarises(tmp_path):
    s = ps.main(["--capture", "--no-remat", "--device", "cpu",
                 "--num-envs", "8", "--iters", "2",
                 "--env", "Track2D-EmptyPartialRam-v0",
                 "--trace-dir", str(tmp_path / "cap")])
    _check_summary(s)
