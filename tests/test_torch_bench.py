"""The port's bench (active_tracking_rl_torch/run/bench.py) on the CPU, at
tiny shapes: Track2D-BlockPartialRam-v0 (no floods), 16 envs, 4 steps, 2
timed iterations.

* The CLI prints one JSON line with the root bench.py's keys and the
  port's (remat, precision, device); ``vs_baseline`` is null.
* The timed loop runs `iters` iterations after bench.py's 2 untimed ones.
* ``--pool-refresh`` K > 1 rounds the timed iterations up to whole refresh
  periods as bench.py does, and refreshes the external pool every K.
* ``--sweep`` runs the configs of bench.py's ``--sweep`` under its keys:
  both packages' ``run_bench`` are replaced by a recorder and the two
  dicts and call lists compared.
* ``build_bench``'s TrainConfig and NetConfig are the ones bench.py builds.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_torch.run import bench

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--env", "Track2D-BlockPartialRam-v0",
        "--num-envs", "16", "--num-steps", "4", "--iters", "2"]
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "remat",
             "precision", "device"}


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def counted(monkeypatch):
    """Counts the train step's and the pool function's calls."""
    calls = {"step": 0, "pool": 0}
    make_step, make_pool = bench.make_train_step, bench.make_pool_fn

    def make_train_step(*a, **k):
        step = make_step(*a, **k)

        def counted_step(*sa, **sk):
            calls["step"] += 1
            return step(*sa, **sk)
        return counted_step

    def make_pool_fn(*a, **k):
        pool_fn = make_pool(*a, **k)

        def counted_pool(*pa):
            calls["pool"] += 1
            return pool_fn(*pa)
        return counted_pool

    monkeypatch.setattr(bench, "make_train_step", make_train_step)
    monkeypatch.setattr(bench, "make_pool_fn", make_pool_fn)
    return calls


def test_cli_prints_one_line_and_times_iters_steps(capsys, counted):
    res = bench.main(TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS
    assert line["metric"] == "env_steps_per_s_per_chip"
    assert line["vs_baseline"] is None
    assert (line["remat"], line["precision"], line["device"]) == (
        True, "fp32", "cpu")
    assert line["unit"] == ("env-steps/s/chip (Track2D-BlockPartialRam "
                            "train pipeline, pool-refresh 1)")
    assert line["value"] == round(res.env_steps_per_s, 1) > 0
    # 2 untimed iterations, then the 2 timed ones, each a fresh pool inside
    # the step; Ram floods nothing
    assert counted == {"step": 4, "pool": 0}
    assert res.iters == 2 and len(res.losses) == 2
    assert res.launches == {"flood_sweep": 0, "flood_sweep16": 0,
                            "flood_relax": 0}
    assert res.env_steps_per_s == pytest.approx(2 * 16 * 4 / res.seconds)


def test_pool_refresh_rounds_iters_up_as_bench_py(capsys, counted):
    res = bench.main(TINY + ["--pool-refresh", "3", "--no-remat", "--bf16"])
    line = json.loads(capsys.readouterr().out)
    assert (line["remat"], line["precision"]) == (False, "bf16")
    assert line["unit"].endswith("pool-refresh 3)")
    k, iters = 3, 2
    assert res.iters == ((iters // k) + 1) * k == 3
    # warm-up at indices 0, 1 (a pool at 0), timed at 0, 1, 2 (a pool at 0)
    assert counted == {"step": 2 + 3, "pool": 2}


def test_sweep_runs_bench_py_configs_under_its_keys(monkeypatch, capsys):
    jax_bench = _jax_bench()
    got_calls, want_calls = [], []

    def recorder(calls, wrap):
        def run_bench(**kw):
            calls.append(kw)
            return wrap(len(calls))
        return run_bench

    monkeypatch.setattr(jax_bench, "run_bench",
                        recorder(want_calls, float))
    monkeypatch.setattr(bench, "run_bench", recorder(
        got_calls, lambda n: bench.BenchResult(float(n), 1, 1.0, [], {}, 0,
                                               True, "fp32", "cpu")))
    monkeypatch.setattr("sys.argv", ["bench.py", "--sweep"])
    jax_bench.main()
    want = json.loads(capsys.readouterr().out)
    got = bench.main(["--sweep", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got == want
    assert len(got) == 9
    assert [dict(c, device="cpu") for c in want_calls] == got_calls


def test_build_bench_configs_are_bench_py_s():
    from active_tracking_rl_tpu.config import NetConfig as JNetConfig
    from active_tracking_rl_tpu.config import TrainConfig as JTrainConfig
    b = bench.build_bench(num_envs=16, num_steps=4,
                          env_id="Track2D-BlockPartialPZR-v0",
                          network="tat-maze-lstm", train_mode=-1, bf16=True,
                          remat=False, device="cpu")
    jt = JTrainConfig(env_id="Track2D-BlockPartialPZR-v0", num_envs=16,
                      reset_pool=max(16 // 8, 64), num_steps=4,
                      train_mode=-1, remat=False)
    jn = dataclasses.replace(JNetConfig.from_name("tat-maze-lstm",
                                                  aux="reward"), bf16=True)
    assert dataclasses.asdict(b.tcfg) == dataclasses.asdict(jt)
    assert dataclasses.asdict(b.ncfg) == dataclasses.asdict(jn)
    assert b.mode == -1 and b.carry.obs_stack.shape[0] == 16
