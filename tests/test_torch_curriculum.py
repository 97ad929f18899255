"""The port's train-mode schedule (active_tracking_rl_torch/rl/curriculum.py)
against the JAX package's ``rl/curriculum.py``: the same mode, last switch
and phase length at every iteration of 4000, for train modes 0, 1, -1 and 2
(the warmup at init_step, the pinned modes, mode 2's alternation and its
documented timing). Plain integers: exact equality."""

import dataclasses

import pytest

from active_tracking_rl_tpu.config import TrainConfig as JTrainConfig
from active_tracking_rl_tpu.rl import curriculum as jcur
from active_tracking_rl_torch.config import TrainConfig
from active_tracking_rl_torch.rl import curriculum

ITERS = 4000


def _schedules(train_mode, init_step, adv_step):
    tcfg = TrainConfig(train_mode=train_mode, init_step=init_step,
                       adv_step=adv_step)
    jcfg = JTrainConfig(train_mode=train_mode, init_step=init_step,
                        adv_step=adv_step)
    st, jst = curriculum.CurriculumState.initial(tcfg), \
        jcur.CurriculumState.initial(jcfg)
    got, want = [dataclasses.astuple(st)], [dataclasses.astuple(jst)]
    for it in range(1, ITERS + 1):
        st = curriculum.update(tcfg, st, it)
        jst = jcur.update(jcfg, jst, it)
        got.append(dataclasses.astuple(st))
        want.append(dataclasses.astuple(jst))
    return got, want


@pytest.mark.parametrize("train_mode", [0, 1, -1, 2])
@pytest.mark.parametrize("init_step,adv_step", [(-1, 500), (1000, 500),
                                                (3, 7)])
def test_schedule_matches_jax(train_mode, init_step, adv_step):
    got, want = _schedules(train_mode, init_step, adv_step)
    assert got == want
    modes = [s[0] for s in got[1:]]
    warm = max(init_step - 1, 0)
    assert modes[:warm] == [0] * warm
    if train_mode != 2:
        assert set(modes[warm:]) == {train_mode}


def test_alternation_timing_as_documented():
    """init_step 1000, adv_step 500: mode 1 from iteration 2000 (twice
    init_step), then each phase flips once more than its length has
    passed: 0 from 2501, 1 from 3502."""
    got, _ = _schedules(2, 1000, 500)
    flips = [it for it in range(1, ITERS + 1) if got[it][0] != got[it - 1][0]]
    assert flips == [2000, 2501, 3502]
