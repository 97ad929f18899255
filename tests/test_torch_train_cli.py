"""The port's CLIs (active_tracking_rl_torch/run/) on the CPU, driven
through their ``main``: the trainer's `--debug-nans` abort (mirrors
tests/test_train_cli.py), ``check_finite_metrics``, flag parity with the
JAX trainer's ``build_argparser``, the multi-process flags that cannot
work, and the
evaluation matrix's JSON with Wilson intervals.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import active_tracking_rl_torch.run.train as train_mod
import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_torch.rl.learner import TrainMetrics
from active_tracking_rl_torch.run import eval_matrix
from active_tracking_rl_torch.utils.logging import MetricWriter
from active_tracking_rl_torch.utils.stats import wilson_ci

ROOT = Path(__file__).resolve().parents[1]
RAM = "Track2D-BlockPartialRam-v0"
RAM_TRACKER = str(ROOT / "runs/r3-tracker-ram" / RAM /
                  "Aug21_00-06/tracker-best.msgpack")


@pytest.fixture(autouse=True)
def jsonl_only(monkeypatch):
    """Scalars to metrics.jsonl only: importing TensorBoard's writer pulls
    in a large framework on hosts that have one, which these small runs do
    not need."""
    monkeypatch.setattr(train_mod, "MetricWriter",
                        functools.partial(MetricWriter,
                                          use_tensorboard=False))


def test_debug_nans_aborts_within_one_iteration(tmp_path, monkeypatch):
    """A NaN injected into the metrics the first time the curriculum flips
    to mode 1 (iteration 2 with --train-mode 2 --init-step 1 --adv-step 1)
    aborts that iteration, named in the error."""
    real_make = train_mod.make_train_step

    def nan_make_train_step(*a, **kw):
        real = real_make(*a, **kw)

        def step(carry, mode, *rest):
            carry, m, ptr = real(carry, mode, *rest)
            if mode == 1:
                m = m._replace(loss=torch.tensor(float("nan")))
            return carry, m, ptr

        return step

    monkeypatch.setattr(train_mod, "make_train_step", nan_make_train_step)
    with pytest.raises(FloatingPointError, match=r"iter 2\b.*'loss'"):
        train_mod.main([
            "--device", "cpu", "--env", RAM, "--env-base", RAM,
            "--network", "tat-maze-lstm",
            "--train-mode", "2", "--init-step", "1", "--adv-step", "1",
            "--num-envs", "16", "--reset-pool", "8",
            "--total-iters", "10", "--checkpoint-every", "1000",
            "--debug-nans", "--log-dir", str(tmp_path)])


def test_check_finite_metrics_names_fields():
    clean = TrainMetrics(*[torch.tensor(0.0)] * 9)
    train_mod.check_finite_metrics(clean, 3)   # no raise
    bad = clean._replace(grad_norm=torch.tensor(float("inf")),
                         policy_loss=torch.tensor([0.0, float("nan")]))
    with pytest.raises(FloatingPointError,
                       match=r"iter 3\b.*policy_loss.*grad_norm"):
        train_mod.check_finite_metrics(bad, 3)


def test_flags_match_the_jax_cli():
    """Every dest of the JAX trainer's parser, with its default; the port
    adds only --device and --dist-backend, and --split gains its
    --no-split negation."""
    from active_tracking_rl_tpu.run.train import build_argparser as jparser
    jax_defaults = {a.dest: a.default for a in jparser()._actions}
    port = train_mod.build_argparser()
    port_defaults = {a.dest: a.default for a in port._actions}
    assert set(port_defaults) - set(jax_defaults) == {"device",
                                                      "dist_backend"}
    assert port_defaults["device"] == "cuda"
    assert port_defaults["dist_backend"] is None
    for dest, default in jax_defaults.items():
        assert dest in port_defaults, dest
        assert port_defaults[dest] == default, dest
    assert port.parse_args([]).split is True
    assert port.parse_args(["--no-split"]).split is False
    args = port.parse_args(["--no-remat", "--bf16", "--optimizer", "RMSprop"])
    tcfg = train_mod.train_config_from_args(args)
    assert (tcfg.remat, tcfg.bf16, tcfg.optimizer) == (False, True, "RMSprop")
    assert train_mod.train_config_from_args(port.parse_args([])).remat
    ncfg = train_mod.net_config_from_args(args, tcfg)
    assert (ncfg.name, ncfg.bf16) == ("tat-maze-lstm", True)


@pytest.mark.parametrize("flags,item", [
    (["--num-processes", "2", "--process-id", "1"], "needs --coordinator"),
    (["--coordinator", "localhost:1234"], "needs --num-processes > 1"),
    (["--local-devices", "4"], "no virtual devices")])
def test_unported_features_raise(tmp_path, flags, item):
    """Multi-process training is ported; the flags that cannot work raise a
    ValueError naming what is missing, before any rendezvous: ranks
    without rank 0's address, an address for one process, and virtual
    devices, which torch does not have."""
    with pytest.raises(ValueError, match=item):
        train_mod.main(["--device", "cpu", "--env", RAM, "--env-base", RAM,
                        "--num-envs", "4", "--reset-pool", "4",
                        "--log-dir", str(tmp_path)] + flags)


def test_continuous_network_is_refused(tmp_path):
    """Track2D's actions are discrete: the CLI refuses a continuous network
    and names the host-env trainer, which trains it."""
    with pytest.raises(ValueError, match="train_host"):
        train_mod.main(["--device", "cpu", "--env", RAM, "--env-base", RAM,
                        "--num-envs", "4", "--reset-pool", "4",
                        "--network", "tat-maze-lstm-continuous",
                        "--log-dir", str(tmp_path)])


def test_eval_matrix_writes_wilson_intervals(tmp_path):
    out = tmp_path / "matrix.json"
    results = eval_matrix.main([
        "--device", "cpu", "--tracker", f"ram={RAM_TRACKER}", "--env", RAM,
        "--num-episodes", "4", "--eval-seeds", "2", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(results))
    row = saved[RAM]["ram"]
    assert row["episodes"] == 8 and len(row["ep_returns"]) == 8
    assert len(row["per_seed"]) == 2
    succ = round(row["S_rate"] * 8)
    assert row["S_ci95"] == wilson_ci(succ, 8)
    assert row["S_ci95"][0] <= row["S_rate"] <= row["S_ci95"][1]
    assert row["R_mean"] == pytest.approx(np.mean(row["ep_returns"]),
                                          abs=0.01)


def test_wilson_ci_matches_jax():
    from active_tracking_rl_tpu.utils.stats import wilson_ci as j_wilson
    for s, n in ((0, 0), (0, 10), (3, 10), (297, 300), (300, 300)):
        assert wilson_ci(s, n) == j_wilson(s, n)


def test_profile_dir_writes_a_trace_of_iterations_10_to_15(tmp_path):
    s = train_mod.main(["--device", "cpu", "--env", RAM, "--env-base", RAM,
                        "--num-envs", "4", "--reset-pool", "4",
                        "--num-steps", "2", "--test-eps", "2",
                        "--total-iters", "16", "--log-dir", str(tmp_path),
                        "--profile-dir", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("profiler trace written" in line
               for line in (Path(s.run_dir) / "logger").read_text()
               .splitlines())
