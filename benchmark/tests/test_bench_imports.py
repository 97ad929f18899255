"""No module that a run loads is JAX's or the JAX package's, the
reference loads nothing of the program, and the entry point refuses to run
without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness



def _py(code: str, tmp_path) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys
from pathlib import Path
sys.path.insert(0, {str(harness.ROOT)!r})
from benchmark import control, harness
from benchmark.tests import tiny
import benchmark.cell, benchmark.faults
root, path = tiny.make(Path({str(tmp_path)!r}))
for w in ("tracker-nav.tiny1", "advat.tiny2"):
    cell = harness.load_cell(w, root, path)
    res = harness.run_cell(w, 5, 0.2, True, "cpu", None, root, path)
    assert res["correct"], res
print("FORBIDDEN", harness.forbidden_modules())
print("TOP", sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = _py(code, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    top = out.stdout.split("TOP", 1)[1]
    for name in harness.FORBIDDEN:
        assert f"'{name}'" not in top


def test_forbidden_names_are_compared_whole():
    sys.modules["active_tracking_rl_tpu_like"] = sys
    try:
        assert "active_tracking_rl_tpu_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["active_tracking_rl_tpu_like"]
    assert all(not m.startswith("active_tracking_rl_torch")
               for m in harness.forbidden_modules())


def test_reference_imports_nothing_of_the_program(tmp_path):
    ref = harness.HERE / "reference"
    for src in ref.glob("*.py"):
        tree = ast.parse(src.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("torch", "benchmark",
                                           "__future__", "math",
                                           "dataclasses", "typing"), (src, n)
                assert not n.startswith("benchmark.") or n.startswith(
                    "benchmark.reference"), (src, n)
    code = f"""
import importlib.abc, json, sys
sys.path.insert(0, {str(harness.ROOT)!r})
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("active_tracking_rl_torch", "jax",
                                  "active_tracking_rl_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from benchmark.reference.learner import run_reference
cfg = json.load(open({str(harness.HERE / 'configs' / 'advat.json')!r}))
out = run_reference(cfg, {{"num_envs": 8, "num_steps": 2, "reset_pool": 4,
                          "pool_refresh": 2}}, 3, 2)
print("LOSSES", out["losses"])
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = _py(code, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOSSES" in out.stdout
    assert "active_tracking_rl_torch" not in out.stdout.split("LOADED")[1]


def test_entry_point_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    env = dict(os.environ)
    out = subprocess.run([sys.executable,
                          str(harness.HERE / "run.py"), "--workload",
                          "tracker-nav.pool1.n16384", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    """One short run of the first cell on the card (the card's machine)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"),
                          "--workload", "tracker-nav.pool1.n16384", "--seed",
                          "2147483701", "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
