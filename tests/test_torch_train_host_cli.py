"""The port's host-env trainer CLI (``run/train_host.py``) on the CPU: its
flags against the JAX CLI's, and a 2-iteration run whose log, metrics rows
and checkpoint files are there, with a tracker file that the JAX package
loads against its own template.
"""

import functools
import json
from pathlib import Path

import jax
import numpy as np
from flax import serialization

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.run.train_host import build_argparser as jparser
from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.models.dueling import params_to_flax
from active_tracking_rl_torch.run import train_host
from active_tracking_rl_torch.utils.logging import MetricWriter

RAM = "Track2D-EmptyPartialRam-v0"


def test_flags_match_the_jax_cli():
    """Every dest of the JAX parser with its default; the port adds only
    --device."""
    jax_defaults = {a.dest: a.default for a in jparser()._actions}
    port_defaults = {a.dest: a.default
                     for a in train_host.build_argparser()._actions}
    assert set(port_defaults) - set(jax_defaults) == {"device"}
    assert port_defaults.pop("device") == "cuda"
    assert port_defaults == jax_defaults


def test_two_iterations_write_files_jax_loads(tmp_path, monkeypatch):
    monkeypatch.setattr(train_host, "MetricWriter",
                        functools.partial(MetricWriter,
                                          use_tensorboard=False))
    run = train_host.main(["--device", "cpu", "--env", RAM, "--num-envs",
                           "2", "--num-steps", "4", "--total-iters", "2",
                           "--checkpoint-every", "2", "--log-dir",
                           str(tmp_path)])
    run_dir = Path(run.run_dir)
    assert run_dir.parent == tmp_path / f"{RAM}-host"
    files = {p.name for p in run_dir.iterdir()}
    assert {"logger", "metrics.jsonl", "ckpt_meta.json", "train_state.pt",
            "all-new.msgpack", "tracker-new.msgpack",
            "target-new.msgpack"} <= files
    rows = [json.loads(x) for x in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1]
    assert np.isfinite(list(rows[0].values())).all()
    log = (run_dir / "logger").read_text()
    assert "iter 1 loss" in log and "checkpoint iter 2" in log
    assert run.trainer.pool.resets >= 2
    assert np.isfinite(run.last_metrics["loss"])

    # JAX reads the tracker file against its own template, and it holds the
    # trained parameters
    template = jbuild(JNetConfig.from_name("maze-lstm", aux="none"), 4,
                      (13, 13)).init(jax.random.PRNGKey(0))["player0"]
    loaded = serialization.from_bytes(
        template, (run_dir / "tracker-new.msgpack").read_bytes())
    want = params_to_flax(run.trainer.model.state_dict(),
                          NetConfig.from_name("maze-lstm"))["player0"]
    got, want = (jax.tree_util.tree_leaves(t) for t in (loaded, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)
