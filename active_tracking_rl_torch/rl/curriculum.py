"""Train-mode scheduling: which loss each learner iteration trains.

The port's copy of ``active_tracking_rl_tpu/rl/curriculum.py`` (plain
Python, the same rules):
  * while the iteration count is below init_step: mode 0 (tracker-only
    warmup);
  * train_mode in {0, 1, -1}: pinned to that mode after warmup;
  * train_mode == 2: after warmup, alternate a target phase (mode 1,
    `adv_step` iterations) and a tracker phase (mode 0, `init_step`
    iterations), starting with the target. `last_switch` follows the
    warmup's end, so the first tracker phase runs 2 x init_step iterations
    before the first flip, and a phase flips once more than its length has
    passed: with init_step 1000 and adv_step 500, mode 1 from iteration
    2000, 0 from 2501, 1 from 3502. (The JAX module's docstring cites 2550
    and 3550, observed in a training run; its `update` gives 2501 and 3502,
    as this copy does.)
"""

from __future__ import annotations

import dataclasses

from active_tracking_rl_torch.config import TrainConfig


@dataclasses.dataclass
class CurriculumState:
    mode: int
    last_switch: int
    phase_len: int

    @classmethod
    def initial(cls, tcfg: TrainConfig) -> "CurriculumState":
        if tcfg.train_mode == 2:
            return cls(mode=0, last_switch=0, phase_len=max(tcfg.init_step, 0))
        return cls(mode=tcfg.train_mode, last_switch=0, phase_len=0)


def update(tcfg: TrainConfig, st: CurriculumState,
           n_iter: int) -> CurriculumState:
    """Advance the schedule given the global iteration count."""
    if n_iter < tcfg.init_step:
        return dataclasses.replace(st, mode=0, last_switch=n_iter)
    if tcfg.train_mode != 2:
        return dataclasses.replace(st, mode=tcfg.train_mode)
    if n_iter - st.last_switch > st.phase_len:
        new_mode = 1 if st.mode != 1 else 0
        phase = tcfg.init_step if new_mode == 0 else tcfg.adv_step
        return CurriculumState(mode=new_mode, last_switch=n_iter,
                               phase_len=max(phase, 1))
    return st
