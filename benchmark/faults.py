"""Faults planted under the timed path, and the lower precision, for the
check's control and its tests. Each is planted in the process that runs
the program, after the program is built and before its first step.

* ``bf16``: the program's own bfloat16 path (``NetConfig.bf16``), set when
  the model is built: the control;
* ``no_update``: the step returns its state unchanged (the optimizer does
  nothing);
* ``half_batch``: the loss's mean taken over half of the rows, the rest
  left out;
* ``altered_action``: every row's tracker action altered (a + 1 mod A) at
  the first rollout step of each iteration, where the env takes it.
"""

from __future__ import annotations

VARIANTS = ("bf16", "no_update", "half_batch", "altered_action")


def plant(variant, trainer):
    """Plant `variant` (None: nothing) under `trainer` (``cell.Trainer``);
    returns the function that takes it out again."""
    if variant in (None, "bf16"):
        return lambda: None
    if variant == "no_update":
        trainer.opt.step = lambda *a, **k: None
        return lambda: None
    if variant == "half_batch":
        from active_tracking_rl_torch.rl import learner
        loss_fn = learner.dueling_loss

        def half(*a, **k):
            stats = loss_fn(*a, **k)
            return stats._replace(loss=stats.loss[:stats.loss.shape[0] // 2])

        learner.dueling_loss = half
        return lambda: setattr(learner, "dueling_loss", loss_fn)
    if variant == "altered_action":
        env, steps = trainer.env, trainer.tcfg.num_steps
        step = env.step
        calls = [0]

        def altered(state, actions):
            if calls[0] % steps == 0:
                actions = actions.clone()
                actions[:, 0] = (actions[:, 0] + 1) % env.num_actions
            calls[0] += 1
            return step(state, actions)

        env.step = altered
        return lambda: None
    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
