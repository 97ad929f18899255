"""The port's evaluation CLI (active_tracking_rl_torch/run/eval.py) on the
CPU with the JAX package's committed Ram tracker
(runs/r3-tracker-ram/.../tracker-best.msgpack, read through the port's
flax-format decoder): 300 greedy episodes of 500 steps on
Track2D-BlockPartialRam-v0 must keep the target in view to the end in at
least 95% of episodes. The JAX package's evaluation of this tracker scored
S_rate 0.990 on 300 episodes (RESULTS.md §2). The CSV row carries the
metrics that the CLI returns.
"""

import csv
from pathlib import Path

import numpy as np

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_torch.run import eval as eval_cli

ROOT = Path(__file__).resolve().parents[1]
RAM = "Track2D-BlockPartialRam-v0"
TRACKER = ROOT / "runs/r3-tracker-ram" / RAM / "Aug21_00-06/tracker-best.msgpack"


def test_ram_tracker_succeeds_through_the_eval_cli(tmp_path):
    out = tmp_path / "eval.csv"
    m = eval_cli.main(["--device", "cpu", "--env", RAM,
                       "--network", "tat-maze-lstm",
                       "--load-tracker", str(TRACKER),
                       "--num-episodes", "300", "--log-dir", str(tmp_path),
                       "--csv", str(out)])
    assert m["ep_lens"].shape == (300,)
    assert float(m["S_rate"]) >= 0.95, m["S_rate"]
    assert np.isclose(float(m["S_rate"]), (m["ep_lens"] >= 500).mean())
    rows = list(csv.DictReader(out.open()))
    assert len(rows) == 1 and rows[0]["Env"] == RAM
    assert float(rows[0]["S_rate"]) == float(m["S_rate"])
    assert float(rows[0]["R_mean"]) == float(m["R_mean"][0])
    log = (tmp_path / f"{RAM}_mon_log").read_text()
    assert "S_rate" in log and "EL_mean" in log
