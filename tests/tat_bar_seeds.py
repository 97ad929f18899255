"""The TAT-continuous learning bar of tests/test_continuous_tat.py, one
trainer seed at a time, for the JAX package on the CPU.

The bar: tat-maze-lstm-continuous with the aux reward at mode -1, 150
iterations at 32 envs x 8 steps on the two-player direction pool (seed 5);
the tracker's late return must exceed its early return by 2, and the mean
pred_loss of the last 20 iterations must be below 0.8 x that of the first
20. Prints, per seed, the returns, the pred_loss ratio and the pred_loss
means of each 10 iterations. From the repository root:

    JAX_PLATFORMS=cpu python tests/tat_bar_seeds.py 0,1,2

The port's sweep, on the card and on the CPU, is
`python3 chip_smoke.py --tat-seeds 0-7`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ITERS = 150


def main(argv=None) -> None:
    seeds = (argv or sys.argv[1:])[0]
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from active_tracking_rl_tpu.config import NetConfig, TrainConfig
    from active_tracking_rl_tpu.models.dueling import build_model
    from active_tracking_rl_tpu.rl.host_loop import HostTrainer
    from test_continuous_tat import TwoPlayerDirectionPool
    ncfg = NetConfig.from_name("tat-maze-lstm-continuous", aux="reward")
    tcfg = TrainConfig(num_envs=32, num_steps=8, train_mode=-1, lr=1e-3,
                       entropy_target=0.01)
    for seed in (int(s) for s in seeds.split(",")):
        tr = HostTrainer(build_model(ncfg, num_actions=2, obs_hw=(13, 13)),
                         ncfg, tcfg, TwoPlayerDirectionPool(32, seed=5),
                         seed=seed, action_low=np.full(2, -2.0),
                         action_high=np.full(2, 2.0))
        preds = np.array([float(tr.train_iter(mode=-1).pred_loss)
                          for _ in range(ITERS)])
        rets = np.asarray(tr.finished_returns, np.float64)
        early = rets[:len(rets) // 3].mean()
        late = rets[-len(rets) // 3:].mean()
        ratio = preds[-20:].mean() / preds[:20].mean()
        print(f"jax seed {seed}: return {early:.3f} -> {late:.3f}, "
              f"pred_loss x{ratio:.3f}, by 10 iterations "
              f"{[round(float(preds[i:i + 10].mean()), 2) for i in range(0, ITERS, 10)]}",
              flush=True)


if __name__ == "__main__":
    main()
