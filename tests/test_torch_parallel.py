"""Data parallelism on the CPU: the port's ``parallel/`` over gloo.

Two ranks as separate processes (a free localhost port, a timeout on every
wait): ``parallel/mp_check.py`` prints one digest of the parameters on
every rank, and 2 ranks equal one process running the same steps with
``pool_blocks=2`` (integer env state bit for bit; loss and parameters to
1e-5 relative, scaled per tensor by its largest entry: the ranks sum their
row means in another order than one process's mean over all rows). The
collectives on their own: the metrics of ranks with unequal episode counts
are the global ratios, a missing gradient counts as zeros in the average,
rows gather in rank order, the metric sums ride in the gradients'
all-reduce; a group of one over gloo equals ``Mesh()`` (no process group)
bit for bit; ``parallel/scaling.py`` gives a row per dp with each rank's
step seconds and profile, and a skipped row above the cores. And what
must raise: ``MeshSpec(tp=2)``, ``--local-devices 2``, ``pool_blocks``
above 1 over several ranks, a rendezvous whose other rank never comes.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import active_tracking_rl_torch.run.train as train_mod
from active_tracking_rl_torch.parallel import mp_check
from active_tracking_rl_torch.parallel.mesh import (Mesh, MeshSpec,
                                                    free_port, host_init,
                                                    make_mesh, shutdown)
from active_tracking_rl_torch.config import NetConfig, TrainConfig
from active_tracking_rl_torch.rl.learner import (make_train_step,
                                                 metric_sums, step_metrics)
from active_tracking_rl_torch.rl.rollout import Trajectory
from active_tracking_rl_torch.ops.losses import LossStats
from tests.torch_dist import launch

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
TIMEOUT = 240


@pytest.fixture(scope="module")
def mp_ranks(tmp_path_factory):
    """mp_check as 2 gloo ranks -> (MPCHECK lines, rank 0's saved state)."""
    out = tmp_path_factory.mktemp("mp") / "rank0.pt"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "active_tracking_rl_torch.parallel.mp_check",
         "--coordinator", coord, "--num-processes", "2", "--process-id",
         str(r), "--device", "cpu", "--steps", str(STEPS), "--timeout", "60",
         "--out", str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-3000:]
    lines = [re.search(r"MPCHECK .*", t).group(0) for t in texts]
    return lines, torch.load(out)


def test_mp_check_digests_identical(mp_ranks):
    lines, _ = mp_ranks
    fields = [dict(kv.split("=") for kv in line.split()[1:]) for line in lines]
    assert [f["rank"] for f in fields] == ["0", "1"]
    assert all(f["world"] == "2" for f in fields)
    assert fields[0]["digest"] == fields[1]["digest"]
    assert fields[0]["loss"] == fields[1]["loss"]


def test_two_ranks_equal_one_process_with_two_pool_blocks(mp_ranks):
    _, saved = mp_ranks
    model, carry, m = mp_check.run_check(2, "cpu", STEPS, pool_blocks=2)
    for f in dataclasses.fields(carry.env_state):
        assert torch.equal(saved["env_state"][f.name],
                           getattr(carry.env_state, f.name)), f.name
    # the 12 env steps cross the 8-step episodes' end
    assert int(carry.env_state.t.max()) < 12
    for name, want in model.state_dict().items():
        got = saved["params"][name]
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale, name
    np.testing.assert_allclose(float(saved["metrics"]["loss"]),
                               float(m.loss), rtol=1e-5)


def _traj(rank, rows=4, steps=5):
    """A rank's synthetic trajectory and loss terms; rank 1 ends 3 episodes,
    rank 0 one."""
    g = torch.Generator().manual_seed(rank)
    done = torch.zeros(steps, rows, dtype=torch.bool)
    for t, b in ([(1, 2)] if rank == 0 else [(0, 0), (2, 1), (4, 3)]):
        done[t, b] = True
    ep_return = torch.where(done[..., None],
                            torch.randn(steps, rows, 2, generator=g), 0.0)
    ep_len = torch.where(done, torch.randint(1, 50, (steps, rows),
                                             generator=g), 0)
    z = torch.zeros(steps, rows, 2)
    traj = Trajectory(z, z, z, z, done, None, ep_return, ep_len)
    stats = LossStats(*(torch.randn(s, generator=g) for s in
                        ((rows,), (rows, 2), (rows, 2), (rows, 2), (rows,))))
    return stats, traj


def _metrics_rank(rank, world, coordinator):
    host_init(coordinator, world, rank, "gloo", timeout_s=60)
    try:
        mesh = make_mesh(MeshSpec())
        stats, traj = _traj(rank)
        # the sums ride in the gradients' all-reduce, as in the train step
        sums = mesh.average_grads_(torch.nn.Linear(2, 1).parameters(),
                                   metric_sums(stats.loss.mean(), stats,
                                               traj, 5))
        return step_metrics(sums, mesh.world, torch.tensor(1.0))
    finally:
        shutdown()


def test_metrics_with_unequal_episode_counts_are_global_ratios():
    got = launch(_metrics_rank, 2, timeout=TIMEOUT)
    parts = [_traj(r) for r in range(2)]
    stats = LossStats(*(torch.cat([p[0][i] for p in parts])
                        for i in range(5)))
    traj = Trajectory(*(None if parts[0][1][i] is None else
                        torch.cat([p[1][i] for p in parts], dim=1)
                        for i in range(8)))
    want = step_metrics(metric_sums(stats.loss.mean(), stats, traj, 5), 1,
                        torch.tensor(1.0))
    for m in got:
        assert float(m.ep_count) == 4.0
        for name in m._fields:
            np.testing.assert_allclose(getattr(m, name).numpy(),
                                       getattr(want, name).numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    # the mean of the ranks' own ratios is another number
    own = [step_metrics(metric_sums(p[0].loss.mean(), *p, 5), 1,
                        torch.tensor(1.0)) for p in parts]
    assert abs(float(sum(o.ep_len for o in own) / 2) - float(want.ep_len)) > 1


def _collectives_rank(rank, world, coordinator):
    host_init(coordinator, world, rank, "gloo", timeout_s=60)
    try:
        mesh = make_mesh(MeshSpec(dp=2))
        lin = torch.nn.Linear(2, 1)
        torch.nn.init.constant_(lin.weight, float(rank))
        mesh.broadcast_(lin.parameters())
        if rank == 1:   # rank 0's gradients are missing
            lin.weight.grad = torch.full((1, 2), 4.0)
            lin.bias.grad = torch.full((1,), 2.0)
        extra = mesh.average_grads_(lin.parameters(),
                                    torch.tensor([rank + 1.0, 2.0]))
        rows = mesh.gather_rows(torch.tensor([[rank, 10 + rank]]))
        flags = mesh.gather_rows(torch.tensor([rank == 1]))
        return (mesh.rows(6), lin.weight.detach().clone(),
                lin.weight.grad.clone(), lin.bias.grad.clone(), rows, flags,
                extra)
    finally:
        shutdown()


def test_collectives_over_gloo():
    for rank, (rows, w, gw, gb, gathered, flags, extra) in enumerate(
            launch(_collectives_rank, 2, timeout=TIMEOUT)):
        assert rows == (3 * rank, 3 * rank + 3)
        assert torch.equal(w, torch.zeros(1, 2))       # rank 0's values
        assert torch.equal(gw, torch.full((1, 2), 2.0))
        assert torch.equal(gb, torch.full((1,), 1.0))
        assert torch.equal(gathered, torch.tensor([[0, 10], [1, 11]]))
        assert flags.dtype == torch.bool
        assert flags.tolist() == [False, True]
        assert torch.equal(extra, torch.tensor([3.0, 4.0]))   # summed


def test_one_process_mesh_is_the_identity():
    mesh = make_mesh(MeshSpec())
    assert (mesh.world, mesh.rank, mesh.backend) == (1, 0, None)
    t = torch.arange(4.0)
    assert torch.equal(mesh.all_reduce_sum(t), t)
    assert mesh.gather_rows(t) is t
    with pytest.raises(ValueError, match="dp must be -1 or 1"):
        make_mesh(MeshSpec(dp=2))
    assert mesh == Mesh() and Mesh(2, 1).rows(8) == (4, 8)
    lin = torch.nn.Linear(2, 1)
    extra = torch.tensor([1.5])
    assert mesh.average_grads_(lin.parameters(), extra) is extra
    assert lin.weight.grad is None and lin.bias.grad is None


def _group_of_one_rank(rank, world, coordinator):
    host_init(coordinator, 1, 0, "gloo", timeout_s=60, group_of_one=True)
    try:
        mesh = make_mesh(MeshSpec())
        model, _, m = mp_check.run_check(1, "cpu", 2, mesh)
        return mesh.backend, mp_check.digest(model), float(m.loss)
    finally:
        shutdown()


def test_group_of_one_equals_no_process_group():
    (backend, dig, loss), = launch(_group_of_one_rank, 1, timeout=TIMEOUT)
    model, _, m = mp_check.run_check(1, "cpu", 2)
    assert backend == "gloo"
    assert (dig, loss) == (mp_check.digest(model), float(m.loss))


def test_pool_blocks_need_one_rank():
    with pytest.raises(ValueError, match="pool_blocks must be 1"):
        make_train_step(None, None, NetConfig.from_name("maze-lstm"),
                        TrainConfig(), None, pool_blocks=2, mesh=Mesh(2, 0))


def test_mesh_spec_tp_raises():
    with pytest.raises(ValueError, match="tp=2"):
        MeshSpec(tp=2)


def test_local_devices_above_one_raise(tmp_path):
    with pytest.raises(ValueError, match="no virtual devices"):
        train_mod.main(["--device", "cpu", "--local-devices", "2",
                        "--log-dir", str(tmp_path)])


def _lonely_rank(rank, world, coordinator):
    import time
    t0 = time.monotonic()
    try:
        host_init(coordinator, 2, 0, "gloo", timeout_s=3.0)
    except Exception as e:   # the rendezvous must fail, not hang
        return type(e).__name__, time.monotonic() - t0
    shutdown()
    return None, time.monotonic() - t0


def test_rendezvous_without_the_other_rank_raises_within_its_timeout():
    (err, seconds), = launch(_lonely_rank, 1, timeout=60)
    assert err is not None and seconds < 30, (err, seconds)


def test_scaling_rows_on_the_cpu(tmp_path):
    """parallel/scaling.py on the CPU: a row at dp 1 and at dp 2 (each
    rank's step seconds and device-free profile), a skipped row above the
    cores."""
    from active_tracking_rl_torch.parallel import scaling
    prof = tmp_path / "prof"
    out = scaling.main(["--device", "cpu", "--dp", "1", "2", "100000",
                        "--envs-per-device", "4", "--iters", "1",
                        "--env", "Track2D-EmptyPartialRam-v0",
                        "--timeout", str(TIMEOUT),
                        "--profile-dir", str(prof)])
    one, two, big = out["rows"]
    assert (one["dp"], two["dp"]) == (1, 2)
    assert one["weak_scaling_eff"] == 1.0 and two["weak_scaling_eff"] > 0
    for row in (one, two):
        assert len(row["rank_step_s"]) == row["dp"]
        assert row["rank_step_s"][0] == row["step_s"]
        assert [p["mode"] for p in row["rank_profiles"]] == ["cpu"] * row["dp"]
    assert sorted(f.name for f in prof.iterdir()) == [
        "trace-dp1-r0.json", "trace-dp2-r0.json", "trace-dp2-r1.json"]
    assert big["dp"] == 100000 and "CPU core(s)" in big["skipped"]
