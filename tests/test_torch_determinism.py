"""The deterministic mode every entry point of the port pins
(``utils/platform.py:pin_deterministic``): the settings it reads back, its
idempotence, a ``CUBLAS_WORKSPACE_CONFIG`` it finds set, and two runs of
the trainer CLI under it on the CPU, equal bit for bit (no op on the
path raises under the mode). The card's runs are held to the same in
``tests/test_torch_cuda.py``.
"""

import functools
import os

import pytest
import torch

import active_tracking_rl_torch.run.train as train_mod
import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_torch.utils import platform
from active_tracking_rl_torch.utils.logging import MetricWriter
from tests.same_run import compare

PINNED = {"algorithms": True, "warn_only": False,
          "fill_uninitialized_memory": False, "cudnn.deterministic": True,
          "cudnn.benchmark": False, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
RAM = "Track2D-BlockPartialRam-v0"
FLAGS = ["--device", "cpu", "--env", RAM, "--env-base", RAM,
         "--num-envs", "16", "--reset-pool", "8", "--num-steps", "8",
         "--test-eps", "8", "--total-iters", "3", "--checkpoint-every", "3"]


@pytest.fixture(autouse=True)
def global_state(monkeypatch):
    """Each case starts with the mode off and the variable unset, and
    leaves torch's global settings as it found them."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.utils.deterministic.fill_uninitialized_memory,
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    # set, then deleted: the teardown puts back what the process had
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    monkeypatch.setattr(train_mod, "MetricWriter",
                        functools.partial(MetricWriter,
                                          use_tensorboard=False))
    yield
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    (torch.utils.deterministic.fill_uninitialized_memory,
     torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = before[2:]


def test_pin_deterministic_reads_back_the_mode():
    got = platform.pin_deterministic()
    assert got == PINNED
    assert torch.are_deterministic_algorithms_enabled()
    assert not torch.is_deterministic_algorithms_warn_only_enabled()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


def test_pin_deterministic_is_idempotent():
    first = platform.pin_deterministic()
    assert platform.pin_deterministic() == first == PINNED


def test_pin_deterministic_leaves_a_set_workspace_config(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    got = platform.pin_deterministic()
    assert got["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    assert got == dict(PINNED, CUBLAS_WORKSPACE_CONFIG=":16:8")


def test_two_trainer_runs_are_equal_under_the_mode(tmp_path):
    """run/train.py twice with one seed at the smallest width: the mode is
    on (the CLI pinned it), no op raised, and the saved parameters,
    optimizer state and carry and the logged metrics are equal bit for
    bit (tests/same_run.py)."""
    runs = [train_mod.main(FLAGS + ["--log-dir", str(tmp_path),
                                    "--run-name", name]).run_dir
            for name in ("a", "b")]
    assert torch.are_deterministic_algorithms_enabled()
    res = compare(*runs)
    assert res["same"] and res["lines"] == 2, res
