"""Every entry point of the port pins float32 (no TF32) and the
deterministic mode before it builds a model or an env.

Each case runs in a fresh interpreter on the CPU: the TF32 flags are first
set to allow TF32 (the legacy ``allow_tf32`` flags, then the
``fp32_precision`` settings), then the entry point runs at the smallest
flags the CLI tests use, with the constructors of the env (``TrackEnv``),
of the model (``DuelingModel``) and the map generator (``generate_map``)
replaced by a stop that records the flags and ends the run. The flags at
that first build, and after, must read "ieee" for cuBLAS matmuls and for
cuDNN (its convolutions and RNNs) and False through the legacy API:
through the same API that ``utils/platform.py:pin_float32`` sets.
``chip_smoke._no_tf32`` must leave the helper's state.

The same runs start with the deterministic mode off (deterministic
algorithms off, memory fill on, cuDNN nondeterministic with benchmarking,
``CUBLAS_WORKSPACE_CONFIG`` unset); at the first build and after, it must
read as ``utils/platform.py:pin_deterministic`` leaves it, and
``chip_smoke._deterministic`` must leave the same.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, json, os, sys
import torch
import torch.utils.deterministic

b = torch.backends
b.cuda.matmul.allow_tf32 = True
b.cudnn.allow_tf32 = True
for m in (b.cuda.matmul, b.cudnn, b.cudnn.conv, b.cudnn.rnn):
    m.fp32_precision = "tf32"
os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
torch.use_deterministic_algorithms(False)
torch.utils.deterministic.fill_uninitialized_memory = True
b.cudnn.deterministic = False
b.cudnn.benchmark = True


def state():
    return {"matmul": b.cuda.matmul.fp32_precision,
            "cudnn": b.cudnn.fp32_precision,
            "cudnn.conv": b.cudnn.conv.fp32_precision,
            "cudnn.rnn": b.cudnn.rnn.fp32_precision,
            "matmul.allow_tf32": b.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": b.cudnn.allow_tf32}


def det_state():
    return {"algorithms": torch.are_deterministic_algorithms_enabled(),
            "warn_only":
                torch.is_deterministic_algorithms_warn_only_enabled(),
            "fill_uninitialized_memory":
                torch.utils.deterministic.fill_uninitialized_memory,
            "cudnn.deterministic": b.cudnn.deterministic,
            "cudnn.benchmark": b.cudnn.benchmark,
            "CUBLAS_WORKSPACE_CONFIG":
                os.environ.get("CUBLAS_WORKSPACE_CONFIG")}


start, det_start = state(), det_state()
from active_tracking_rl_torch.envs import env as env_mod, maps
from active_tracking_rl_torch.models import dueling
from active_tracking_rl_torch.parallel.mesh import free_port


class Reached(Exception):
    pass


seen = []


def stop(*args, **kwargs):
    seen.append((state(), det_state()))
    raise Reached


env_mod.TrackEnv.__init__ = stop
dueling.DuelingModel.__init__ = stop
maps.generate_map = stop

target, argv = sys.argv[1], json.loads(sys.argv[2])
module, name = target.split(":")
fn = getattr(importlib.import_module(module), name)
try:
    if argv is None:
        fn()
    else:
        fn([a.replace("{port}", str(free_port())) for a in argv])
except Reached:
    pass
print(json.dumps({"start": start, "at_build": seen[0][0] if seen else None,
                  "after": state(), "det_start": det_start,
                  "det_at_build": seen[0][1] if seen else None,
                  "det_after": det_state()}))
"""

PINNED = {"matmul": "ieee", "cudnn": "ieee", "cudnn.conv": "ieee",
          "cudnn.rnn": "ieee", "matmul.allow_tf32": False,
          "cudnn.allow_tf32": False}
DETERMINISTIC = {"algorithms": True, "warn_only": False,
                 "fill_uninitialized_memory": False,
                 "cudnn.deterministic": True, "cudnn.benchmark": False,
                 "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
RAM = "Track2D-BlockPartialRam-v0"
EMPTY = "Track2D-EmptyPartialRam-v0"
PKG = "active_tracking_rl_torch"

#: entry point -> (module:function, argv; "{tmp}" is the case's tmp dir)
ENTRIES = {
    "run.train": ("run.train:setup", [
        "--device", "cpu", "--env", RAM, "--env-base", RAM, "--num-envs",
        "16", "--reset-pool", "8", "--num-steps", "8", "--log-dir", "{tmp}",
        "--run-name", "p"]),
    "run.eval": ("run.eval:main", [
        "--device", "cpu", "--env", RAM, "--num-episodes", "8", "--log-dir",
        "{tmp}"]),
    "run.eval_matrix": ("run.eval_matrix:main", [
        "--device", "cpu", "--tracker", "t={tmp}/t.msgpack", "--env", RAM,
        "--num-episodes", "8", "--eval-seeds", "2", "--out", "{tmp}/m.json"]),
    "run.train_host": ("run.train_host:main", [
        "--device", "cpu", "--env", RAM, "--num-envs", "2", "--num-steps",
        "4", "--total-iters", "2", "--checkpoint-every", "2", "--log-dir",
        "{tmp}"]),
    "run.random_agent": ("run.random_agent:main", [
        "--device", "cpu", "--num-envs", "16", "--seconds", "1"]),
    "run.demo": ("run.demo:main", ["--device", "cpu", "--gif", ""]),
    "run.parity": ("run.parity:main", [
        "record", "--device", "cpu", "--out", "{tmp}/g.npz"]),
    "run.profile_summary": ("run.profile_summary:main", [
        "--capture", "--device", "cpu", "--num-envs", "8", "--iters", "2",
        "--env", EMPTY, "--trace-dir", "{tmp}"]),
    "parallel.scaling --worker": ("parallel.scaling:main", [
        "--worker", "--coordinator", "127.0.0.1:{port}", "--num-processes",
        "1", "--process-id", "0", "--device", "cpu", "--envs-per-device",
        "8", "--iters", "1", "--env", EMPTY]),
    "parallel.mp_check": ("parallel.mp_check:main", [
        "--coordinator", "127.0.0.1:{port}", "--num-processes", "1",
        "--process-id", "0", "--device", "cpu"]),
    "run.bench": ("run.bench:main", [
        "--device", "cpu", "--env", RAM, "--num-envs", "16", "--iters",
        "1"]),
    "run.profile_iter": ("run.profile_iter:main", [
        "--device", "cpu", "--num-envs", "16", "--pool", "8"]),
    "run.bench_flood": ("run.bench_flood:main", [
        "--device", "cpu", "--rows", "2"]),
}


def _run(target, argv):
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, target, json.dumps(argv)], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _entry_run(entry, tmp):
    """One fresh-process run of `entry` (shared by the float32 and the
    deterministic case)."""
    target, argv = ENTRIES[entry]
    return _run(f"{PKG}.{target}", [a.replace("{tmp}", tmp) for a in argv])


@pytest.fixture(scope="module")
def entry_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("entries"))


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_pins_float32_before_it_builds(entry, entry_tmp):
    out = _entry_run(entry, os.path.join(entry_tmp, entry))
    assert out["start"]["matmul"] == "tf32"
    assert out["start"]["cudnn.conv"] == "tf32"
    assert out["at_build"] == PINNED, out
    assert out["after"] == PINNED, out


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_pins_deterministic_before_it_builds(entry, entry_tmp):
    out = _entry_run(entry, os.path.join(entry_tmp, entry))
    assert out["det_start"]["algorithms"] is False
    assert out["det_start"]["CUBLAS_WORKSPACE_CONFIG"] is None
    assert out["det_at_build"] == DETERMINISTIC, out
    assert out["det_after"] == DETERMINISTIC, out


def test_smoke_and_helper_leave_one_state():
    smoke = _run("chip_smoke:_no_tf32", None)
    helper = _run(f"{PKG}.utils.platform:pin_float32", None)
    assert smoke["start"] == helper["start"] != PINNED
    assert smoke["after"] == helper["after"] == PINNED


def test_smoke_and_helper_leave_one_deterministic_state():
    smoke = _run("chip_smoke:_deterministic", None)
    helper = _run(f"{PKG}.utils.platform:pin_deterministic", None)
    assert smoke["det_start"] == helper["det_start"] != DETERMINISTIC
    assert smoke["det_after"] == helper["det_after"] == DETERMINISTIC
