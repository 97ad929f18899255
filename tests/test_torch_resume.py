"""Exact resume through the port's trainer CLI on the CPU (mirrors
tests/test_resume.py): four uninterrupted iterations equal two, a
checkpoint, and `--resume` for two more, bit for bit in the parameters,
the optimizer state and the carry (env state, frame stack, h, c and the
carry generator's state), at pool refresh 1 (a fresh pool inside every
step), at pool refresh 2 (a pool reused for two iterations, with its
autoreset pointer) and at pool refresh 3, where the resumed run starts in
the middle of a pool's window: it regenerates that window's pool from its
iteration's seed and takes the saved pointer.
"""

import functools

import pytest
import torch

import active_tracking_rl_torch.run.train as train_mod
import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_torch.rl.checkpoint import load_train_state
from active_tracking_rl_torch.utils.logging import MetricWriter

RAM = "Track2D-BlockPartialRam-v0"
FLAGS = ["--device", "cpu", "--env", RAM, "--env-base", RAM,
         "--num-envs", "16", "--reset-pool", "8", "--num-steps", "8",
         "--test-eps", "8", "--checkpoint-every", "1000"]


@pytest.fixture(autouse=True)
def jsonl_only(monkeypatch):
    """Scalars to metrics.jsonl only (no TensorBoard import)."""
    monkeypatch.setattr(train_mod, "MetricWriter",
                        functools.partial(MetricWriter,
                                          use_tensorboard=False))


def _assert_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{path}/{i}")
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("refresh", [1, 2, 3])
def test_resume_bit_exact(tmp_path, refresh):
    def run(name, total, *extra):
        return train_mod.main(FLAGS + [
            "--log-dir", str(tmp_path), "--run-name", name,
            "--total-iters", str(total), "--pool-refresh", str(refresh),
            *extra])

    whole = run("whole", 4)
    half = run("half", 2)
    resumed = run("resumed", 4, "--resume", half.run_dir)
    assert resumed.start_iter == 2
    a = load_train_state(whole.run_dir)
    b = load_train_state(resumed.run_dir)
    assert a["step"] == b["step"] == 4
    for key in ("model", "optimizer", "carry", "curriculum", "pool_ptr"):
        _assert_equal(b[key], a[key], key)
    # the live state too, and the saved state is not all zeros
    _assert_equal(resumed.model.state_dict(), whole.model.state_dict())
    assert any(len(s) for s in a["optimizer"]["state"].values())
    assert (refresh > 1) == (a["pool_ptr"] is not None)


def test_resume_restores_what_was_saved(tmp_path):
    """Before it steps, a resumed session holds what the run saved; the
    watermark and the curriculum come back too."""
    first = train_mod.main(FLAGS + ["--log-dir", str(tmp_path), "--run-name",
                                    "first", "--total-iters", "1",
                                    "--train-mode", "2", "--init-step", "1"])
    saved = load_train_state(first.run_dir)
    s = train_mod.setup(FLAGS + ["--log-dir", str(tmp_path), "--run-name",
                                 "second", "--total-iters", "3",
                                 "--train-mode", "2", "--init-step", "1",
                                 "--resume", first.run_dir])
    try:
        assert s.start_iter == 1
        _assert_equal(s.model.state_dict(), saved["model"])
        _assert_equal(s.opt.state_dict(), saved["optimizer"])
        _assert_equal(train_mod.carry_state(s.carry), saved["carry"])
        assert s.ckpt.max_score == saved["max_score"] == first.ckpt.max_score
        assert s.cur == first.cur
    finally:
        train_mod.close_logger(s.log)
