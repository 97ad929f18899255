"""The model's operations a second over the card's float32 peak, in
percent: ``flops.step_flops`` (every player's forward, the trained
players' backward, no recompute) times the window's iterations a second,
over the peak of ``peaks.json`` (float32 outside the tensor cores: TF32 is
off). None on a card that the table lacks."""

from benchmark import flops

UNIT = "%"
SOURCE = "host_clock"
LAYER = "models/"
MOVES = "env_steps_per_s"


def read(run):
    if not run.peaks or not run.iters:
        return None
    achieved = flops.step_flops(run.cfg, run.traffic) * run.iters_per_s
    return 100.0 * achieved / run.peaks["fp32_flops_per_s"]
