"""At a tiny size on the CPU, the program agrees with the reference, and
a run comes out not correct when the program runs in bfloat16 (the
control) or with a fault planted under its timed path: the step leaves
its state unchanged, the loss takes half of the batch, an action is
altered where the env takes it. Each tiny cell is held to the limits of the real cell it
stands for."""

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def _run(files, workload, variant=None, trace=False):
    root, path = files
    return harness.run_cell(workload, 2 ** 31 + 11, 0.3, trace, "cpu",
                            variant, root, path)


@pytest.mark.parametrize("workload", ["tracker-nav.tiny1", "advat.tiny2"])
def test_program_agrees_with_the_reference(files, workload):
    res = _run(files, workload, trace=workload.endswith("tiny1"))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-2:] == ["checks", "_detail"]
    for c in res["checks"].values():
        assert c["value"] < 1e-5


@pytest.mark.parametrize("workload,variant", [
    ("tracker-nav.tiny1", "bf16"), ("advat.tiny2", "bf16"),
    ("tracker-nav.tiny1", "no_update"), ("advat.tiny2", "no_update"),
    ("tracker-nav.tiny1", "half_batch"), ("advat.tiny2", "half_batch"),
    ("tracker-nav.tiny1", "altered_action"),
    ("advat.tiny2", "altered_action")])
def test_control_and_faults_are_not_correct(files, workload, variant):
    res = _run(files, workload, variant)
    assert not res["correct"], res["checks"]


def test_faults_are_taken_out_again(files):
    """A process that planted a fault runs sound after it."""
    _run(files, "advat.tiny2", "half_batch")
    assert _run(files, "advat.tiny2")["correct"]
