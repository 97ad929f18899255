"""The port's flood-backend bench (active_tracking_rl_torch/run/
bench_flood.py) on the CPU at 4 rows, one timed call per backend: the keys
of the root bench_flood.py, each backend's seconds a positive float, and on
the twins the relaxation's fields equal the sweep's on Block and Maze maps
(sweep_equals_relax). The CLI passes its rows and device on and prints the
dict as one JSON object.
The maps and goals it floods are level-0 maps of each id with 16 distinct
free cells each.
"""

import json

import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_torch.run import bench_flood

KEYS = {f"{m}PartialNav_{k}" for m in ("Block", "Maze")
        for k in ("xla_s", "pallas_s", "pallas_sweep_s",
                  "sweep_equals_relax")}


def test_bench_flood_keys_and_sweep_equals_relax():
    out = bench_flood.bench_flood(4, "cpu", iters=1, warmup=0)
    assert set(out) == KEYS
    for k, v in out.items():
        if k.endswith("_s"):
            assert isinstance(v, float) and v > 0, k
    assert out["BlockPartialNav_sweep_equals_relax"] is True
    assert out["MazePartialNav_sweep_equals_relax"] is True


def test_flood_inputs_are_free_cells_of_the_maps():
    for env_id, side in (("Track2D-BlockPartialNav-v0", 82),
                         ("Track2D-MazePartialNav-v0", 81)):
        mz, goals = bench_flood.flood_inputs(env_id, 4, "cpu")
        assert mz.shape == (4, side, side) and goals.shape == (4, 16, 2)
        rows = torch.arange(4)[:, None]
        assert not mz[rows, goals[..., 0].long(), goals[..., 1].long()].any()
        assert all(len({tuple(g) for g in row.tolist()}) == 16
                   for row in goals)


def test_cli_passes_rows_and_prints_one_dict(monkeypatch, capsys):
    calls = []

    def recorder(*args):
        calls.append(args)
        return {"BlockPartialNav_sweep_equals_relax": True}

    monkeypatch.setattr(bench_flood, "bench_flood", recorder)
    out = bench_flood.main(["--device", "cpu", "--rows", "4"])
    assert json.loads(capsys.readouterr().out) == out
    assert out == {"BlockPartialNav_sweep_equals_relax": True}
    assert calls == [(4, "cpu")]
