"""The loader finds every file by its name, refuses names and units with
other characters, and takes a new configuration, traffic mix and metric as
new files; BENCHMARK.json keeps to the contract's shape."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(workload):
    cell = harness.load_cell(workload)
    assert cell.end_to_end and cell.per_layer
    names = [r.name for r in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    for r in cell.per_layer:
        assert r.moves in names


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", ".a", "-a", "", "é",
                                  "x" * 65])
def test_names_with_other_characters_are_refused(name):
    with pytest.raises(harness.BenchError):
        harness.check_name(name, "metric")


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "", "a" * 17,
                                  "a,b"])
def test_units_with_other_characters_are_refused(unit):
    with pytest.raises(harness.BenchError):
        harness.check_unit(unit, "m")


@pytest.mark.parametrize("name,unit", [("env_steps_per_s", "env-steps/s"),
                                       ("a.b-c_1", "%"), ("_x", "s")])
def test_allowed_names_and_units_pass(name, unit):
    assert harness.check_name(name, "m") == name
    assert harness.check_unit(unit, "m") == unit


def test_new_files_are_found_by_name(tmp_path):
    """A throwaway configuration, mix, metric and cell, added as new files
    and entries of a copy: no file that was there changes."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "advat.json").read_text())
    (root / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    (root / "traffic" / "throwaway-mix.json").write_text(json.dumps(
        {"num_envs": 64, "num_steps": 5, "reset_pool": 8,
         "pool_refresh": 4}))
    (root / "metrics" / "throwaway.metric.py").write_text(
        'UNIT = "things/s"\nSOURCE = "program_counter"\n'
        'LAYER = "a layer"\nMOVES = "env_steps_per_s"\n\n'
        'def read(run):\n    return 2.0 * run.traffic["num_steps"]\n')
    (root / "limits" / "throwaway.throwaway-mix.json").write_text(
        json.dumps({"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "throwaway", "source": "x",
                             "file": "benchmark/configs/throwaway.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway.throwaway-mix",
                               "config": "throwaway",
                               "traffic": "throwaway-mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("throwaway.throwaway-mix")
    bench["per_layer"].append({"name": "throwaway.metric",
                               "unit": "things/s", "better": "higher",
                               "source": "program_counter",
                               "layer": "a layer",
                               "moves": "env_steps_per_s",
                               "workloads": ["throwaway.throwaway-mix"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = harness.load_cell("throwaway.throwaway-mix", root, path)
    assert cell.cfg == cfg and cell.traffic["num_steps"] == 5
    reader = {r.name: r for r in cell.per_layer}["throwaway.metric"]
    run = harness.Run(cell.cfg, cell.traffic, "cpu", 1, None, 1.0, 1, 1.0,
                      1.0)
    assert harness.read_metrics([reader], run) == {
        "throwaway.metric": {"value": 10.0, "unit": "things/s"}}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_reader_that_disagrees_with_benchmark_json_is_refused(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["unit"] = "other"
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    with pytest.raises(harness.BenchError):
        harness.load_cell(BENCH["workloads"][0]["name"], root, path)


def test_benchmark_json_has_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    names = set()
    for section, want in keys.items():
        for e in BENCH[section]:
            assert set(e) - {"workloads"} == want, e
            assert e["name"] not in names
            names.add(e["name"])
            harness.check_name(e["name"], section)
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in BENCH["per_layer"]:
        assert e["moves"] in e2e
        if e["name"].endswith("_roofline") or "mfu" in e["name"]:
            assert e["unit"] == "%"
    fours = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4)
    for c in BENCH["configs"]:
        assert Path(harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(re.match(r"^[A-Za-z0-9_./-]+$", p) for p in BENCH["paths"])
