"""The learning-run tools on small made-up records: tests/same_run.py's
log-prefix comparison, tests/learning_curves.py's success-rate bar,
tests/pack_states.py's round trip of a state, and tests/run_slots.py's
host lines and end-of-run bar."""

from __future__ import annotations

import json
import subprocess
import sys
import threading

import torch

from tests.learning_curves import first_at, load, rates, summary, values_at
from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.models.dueling import build_model
from active_tracking_rl_torch.rl.checkpoint import load_params
from tests.pack_states import main as pack_main
from tests.run_slots import bar_held, sample_smi
from tests.same_run import compare_prefix


def _write(run_dir, rows):
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "metrics.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _rows(steps, loss=1.0):
    out = []
    for it in steps:
        out.append({"step": it, "wall": float(it), "train/fps": 7.0 * it,
                    "train/loss": loss * it})
        if it % 200 == 0:
            out.append({"step": it, "test/success_rate": it / 1000.0})
    return out


def test_prefix_holds_for_a_resumed_chain_and_names_the_first_difference(
        tmp_path):
    _write(tmp_path / "want", _rows(range(50, 1001, 50)))
    _write(tmp_path / "a", _rows(range(50, 201, 50)))
    _write(tmp_path / "b", _rows(range(250, 401, 50)))
    chain = f"{tmp_path / 'a'}+{tmp_path / 'b'}"
    assert compare_prefix(str(tmp_path / "want"), chain)["same"]
    _write(tmp_path / "c", _rows(range(250, 401, 50), loss=1.5))
    got = compare_prefix(str(tmp_path / "want"),
                         f"{tmp_path / 'a'}+{tmp_path / 'c'}")
    assert not got["same"]
    assert got["difference"]["got"]["step"] == 250


def test_bar_counts_a_float32_share_of_episodes(tmp_path):
    rows = [{"step": 200 * i, "test/success_rate": s} for i, s in
            enumerate([0.89, 0.9300000071525574, 0.949999988079071,
                       0.99], start=1)]
    _write(tmp_path / "r", rows)
    evals = summary(load(str(tmp_path / "r" / "metrics.jsonl")))["evals"]
    assert first_at(evals, 0.95) == 600
    assert first_at(evals, 1.0) is None


def test_rates_per_call_and_a_scalar_at_chosen_iterations(tmp_path):
    """One run resumed once: each file's seconds an iteration from its own
    train rows (evaluation rows and the gap between calls left out), and
    the target's entropy where it was logged."""
    def rows(steps, t0, per_iter):
        out = []
        for it in steps:
            out.append({"step": it, "wall": t0 + per_iter * it,
                        "train/entropies0": 0.5,
                        "train/entropies1": 1.0 / it})
            if it % 200 == 0:
                out.append({"step": it, "wall": t0 + per_iter * it + 99.0,
                            "test/success_rate": 0.7})
        return out
    _write(tmp_path / "a", rows(range(50, 401, 50), 0.0, 0.5))
    _write(tmp_path / "b", rows(range(450, 801, 50), 1e4, 0.25))
    spec = (f"{tmp_path / 'a' / 'metrics.jsonl'}+"
            f"{tmp_path / 'b' / 'metrics.jsonl'}")
    assert rates(spec) == [0.5, 0.25]
    got = values_at(load(spec), "train/entropies1", [100, 425, 800])
    assert got == {100: 1.0 / 100, 800: 1.0 / 800}


def test_pack_states_keeps_the_highest_state_that_loads(tmp_path):
    run = tmp_path / "logs" / "Env" / "r1"
    run.mkdir(parents=True)
    blob = {"version": 1, "state": {"step": 400, "w": torch.arange(5.0)}}
    torch.save(blob, run / "train_state.pt")
    (run / "train_state_kept.pt").write_bytes(b"cut mid-write")
    _write(run, _rows([50]))
    out = tmp_path / "out"
    assert pack_main([str(tmp_path / "logs"), str(out), "61", "r1"]) == 0
    assert (out / "runs" / "r1" / "metrics.jsonl").exists()
    assert pack_main(["--unpack", str(out / "states" / "r1.400.pt.xz"),
                      str(tmp_path / "back")]) == 0
    back = torch.load(tmp_path / "back" / "train_state.pt", weights_only=True)
    assert back["state"]["step"] == 400
    assert torch.equal(back["state"]["w"], blob["state"]["w"])


def test_players_of_a_packed_state_load_as_the_trainer_s_checkpoints(
        tmp_path):
    """`pack_states.py --players` writes the state's tracker and target in
    the format that run/eval_matrix.py loads: a fresh model that loads
    them has the state's parameters."""
    ncfg = NetConfig.from_name("tat-maze-lstm")
    torch.manual_seed(0)
    model = build_model(ncfg, 4, (13, 13), device="cpu")
    state = {"version": 1, "state": {"step": 600,
                                     "model": model.state_dict()}}
    run = tmp_path / "logs" / "Env" / "r1"
    run.mkdir(parents=True)
    torch.save(state, run / "train_state.pt")
    assert pack_main([str(tmp_path / "logs"), str(tmp_path / "out"), "60",
                      "r1"]) == 0
    packed = tmp_path / "out" / "states" / "r1.600.pt.xz"
    assert pack_main(["--players", str(packed), str(tmp_path / "p")]) == 0
    torch.manual_seed(1)
    fresh = build_model(ncfg, 4, (13, 13), device="cpu")
    load_params(fresh, load_tracker=str(tmp_path / "p/tracker-600.msgpack"),
                load_target=str(tmp_path / "p/target-600.msgpack"))
    want = model.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_sampler_writes_the_host_lines_without_nvidia_smi(tmp_path):
    """One tick of the call's sampler on a machine with no card: the host's
    facts once (nproc, CPU model) and a minute's line with the load, the
    trainer processes running (one of them here) and a core's speed."""
    fake = subprocess.Popen([sys.executable, "-c", "import time; "
                             "time.sleep(60)",
                             "active_tracking_rl_torch.run.train"])
    try:
        stop = threading.Event()
        stop.set()
        sample_smi(tmp_path / "smi-samples.txt", stop)
    finally:
        fake.kill()
        fake.wait()
    lines = (tmp_path / "smi-samples.txt").read_text().splitlines()
    assert len(lines) == 2, lines
    facts, tick = (ln.split() for ln in lines)
    assert facts[0] == "host" and facts[1].startswith("nproc=")
    assert int(facts[1].split("=")[1]) >= 1
    assert any(w.startswith("model=") for w in facts)
    assert tick[0] == "host" and tick[3] == "loadavg"
    assert len(tick[4:9]) == 5 and float(tick[4]) >= 0.0
    trainers = next(w for w in tick if w.startswith("trainers="))
    assert int(trainers.split("=")[1]) >= 1
    spin = next(w for w in tick if w.startswith("spin_ms="))
    assert float(spin.split("=")[1]) > 0.0


def test_a_job_ends_once_its_bar_has_held(tmp_path):
    rows = [{"step": 200 * i, "test/success_rate": s} for i, s in
            enumerate([0.7, 0.949999988079071, 0.9, 0.97], start=1)]
    _write(tmp_path / "r", rows)
    metrics = str(tmp_path / "r" / "metrics.jsonl")
    assert bar_held(metrics, 0.95, 400)
    assert not bar_held(metrics, 0.95, 600)
    assert not bar_held(metrics, 0.98, 0)
