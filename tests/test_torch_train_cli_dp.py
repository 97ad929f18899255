"""The port's trainer CLI, ``run/train.py:main``, as 2 gloo ranks on the CPU
(the settings of the JAX package's tests/test_train_cli_multiproc.py:
Track2D-EmptyPartialRam-v0, maze-lstm, train mode 0, 8 envs, a pool of 4,
4 steps; seed 4, whose 16 env steps end an episode on one row, so the
resume crosses an autoreset), with the pool refreshed every 3 iterations
outside the train step, so the ranks' pool pointers persist across
iterations and the resume at iteration 2 falls inside a refresh window:
rank 1 logs to the ``-r1`` run dir and writes no parameter file,
``train_state.pt`` or ``ckpt_meta.json``; both ranks log the same eval and
``[best]`` lines (their seconds aside); and a 2-rank resume from iteration
2 to 4 ends with the parameters, carry and eval of the uninterrupted run,
bit for bit.
"""

import functools
import os
import re

import pytest
import torch

import active_tracking_rl_torch.run.train as train_mod
from active_tracking_rl_torch.rl.checkpoint import load_train_state
from active_tracking_rl_torch.utils.logging import MetricWriter
from tests.torch_dist import launch

ENV = "Track2D-EmptyPartialRam-v0"
FLAGS = ["--device", "cpu", "--env", ENV, "--env-base", ENV,
         "--network", "maze-lstm", "--aux", "none", "--train-mode", "0",
         "--num-envs", "8", "--reset-pool", "4", "--num-steps", "4",
         "--test-eps", "8", "--checkpoint-every", "2", "--seed", "4",
         "--pool-refresh", "3"]


def _cli_rank(rank, world, coordinator, argv):
    # scalars to metrics.jsonl only (TensorBoard's import is slow)
    train_mod.MetricWriter = functools.partial(MetricWriter,
                                               use_tensorboard=False)
    s = train_mod.main(argv + ["--coordinator", coordinator,
                               "--num-processes", str(world),
                               "--process-id", str(rank)])
    return s.run_dir, {k: v.cpu() for k, v in s.model.state_dict().items()}


def _run(tmp, name, total, *extra):
    return launch(_cli_rank, 2, ([*FLAGS, "--log-dir", str(tmp),
                                  "--run-name", name, "--total-iters",
                                  str(total), *extra],), timeout=300)


def _evals(run_dir):
    with open(os.path.join(run_dir, "logger")) as f:
        return [re.sub(r" \([0-9.]+ s\)", "", line.split(" : ", 1)[1].strip())
                for line in f if "eval iter" in line]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    whole = _run(tmp, "whole", 4)
    first = _run(tmp, "first", 2)
    resumed = _run(tmp, "resumed", 4, "--resume", first[0][0])
    return whole, first, resumed


def test_only_the_lead_writes_files(runs):
    whole, _, _ = runs
    (lead_dir, _), (r1_dir, _) = whole
    assert r1_dir == lead_dir + "-r1"
    lead_files = set(os.listdir(lead_dir))
    assert {"all-best.msgpack", "tracker-best.msgpack",
            "train_state.pt", "ckpt_meta.json"} <= lead_files
    r1_files = set(os.listdir(r1_dir))
    assert {"logger", "metrics.jsonl"} <= r1_files
    assert not any(f.endswith(".msgpack") or f in ("train_state.pt",
                                                   "ckpt_meta.json")
                   for f in r1_files), r1_files


def test_ranks_log_the_same_evals_and_best(runs):
    for run in runs:
        (lead_dir, lead_params), (r1_dir, r1_params) = run
        evals = _evals(lead_dir)
        assert evals and evals == _evals(r1_dir)
        assert any("[best]" in e for e in evals)
        for k, v in lead_params.items():
            assert torch.equal(v, r1_params[k]), k


def test_two_rank_resume_is_exact(runs):
    whole, _, resumed = runs
    (w_dir, w_params), _ = whole
    (r_dir, r_params), _ = resumed
    for k, v in w_params.items():
        assert torch.equal(v, r_params[k]), k
    assert _evals(r_dir) == _evals(w_dir)[1:]
    assert "eval iter 4" in _evals(r_dir)[0]
    w_state, r_state = load_train_state(w_dir), load_train_state(r_dir)
    assert w_state["world"] == r_state["world"] == 2
    for k, v in w_state["carry"]["env_state"].items():
        assert v.shape[0] == 8 and torch.equal(v, r_state["carry"][
            "env_state"][k]), k
    assert torch.equal(w_state["carry"]["generator"],
                       r_state["carry"]["generator"])
    assert w_state["pool_ptr"].shape == (2,)
    assert torch.equal(w_state["pool_ptr"], r_state["pool_ptr"])
    # the 16 env steps crossed an episode boundary on some row
    assert int(w_state["carry"]["env_state"]["t"].min()) < 16
