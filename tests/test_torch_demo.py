"""The port's demo (``run/demo.py``) against the JAX package's, with the
AD-VAT checkpoint (tat-maze-lstm) on Track2D-BlockPartialNav-v0.

The JAX demo's own ``main`` runs one greedy episode from its seed (its
GIF writer is replaced by one that keeps the frames); the port's
``run_episode`` runs from the reset draws JAX's GymTrackEnv makes from that
seed (tests/torch_draws.py). Frames (integer RGB renders), the length and
the tracker's return must be equal; an episode of length L has L + 1
frames. Then the port's ``main`` writes the GIF, and `--gif` without PIL
raises before any episode.
"""

import builtins
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import parse_env_id as jparse
from active_tracking_rl_tpu.envs import render as jrender
from active_tracking_rl_tpu.run import demo as jdemo
from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.envs.bridge import GymTrackEnv
from active_tracking_rl_torch.models.dueling import build_model
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.checkpoint import load_params
from active_tracking_rl_torch.run import demo
from tests.torch_draws import reset_draws, torch_cfg

ROOT = Path(__file__).resolve().parents[1]
RUN = ROOT / "runs/r5-advat-s3-ext2/Track2D-BlockPartialPZR-v0/Aug21_19-24"
ENV = "Track2D-BlockPartialNav-v0"
SEED = 3
FILES = ["--load-tracker", str(RUN / "tracker-best.msgpack"),
         "--load-target", str(RUN / "target-best.msgpack")]


def test_episode_matches_the_jax_demo(monkeypatch, capsys):
    kept = []
    monkeypatch.setattr(jrender, "save_episode_gif",
                        lambda frames, path: kept.extend(frames))
    jdemo.main(["--env", ENV, "--seed", str(SEED), "--gif", "unused.gif",
                *FILES])
    line = next(l for l in capsys.readouterr().out.splitlines()
                if l.startswith("episode 0"))

    ncfg = NetConfig.from_name("tat-maze-lstm")
    cfg = torch_cfg(jparse(ENV))
    model = build_model(ncfg, cfg.num_actions, cfg.obs_shape, device="cpu",
                        generator=Threefry().manual_seed(0))
    load_params(model, None, *FILES[1::2])
    _, k = jax.random.split(jax.random.PRNGKey(SEED))
    frames, length, ret = demo.run_episode(
        model, GymTrackEnv(ENV, cfg=cfg, device="cpu"), ncfg,
        reset_draws(jparse(ENV), k[None]))
    assert line == f"episode 0: len {length} tracker return {ret:.1f}"
    assert len(frames) == len(kept) == length + 1
    for t, (got, want) in enumerate(zip(frames, kept)):
        np.testing.assert_array_equal(got, want, err_msg=f"frame {t}")


def test_main_writes_the_gif(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image
    gif = tmp_path / "demo.gif"
    (frames, length, _), = demo.main(["--device", "cpu", "--env",
                                      "Track2D-EmptyPartialRam-v0",
                                      "--gif", str(gif), *FILES])
    assert len(frames) == length + 1
    with Image.open(gif) as img:
        # PIL folds identical consecutive frames into one
        assert 1 < img.n_frames <= length + 1
        assert img.size == (frames[0].shape[1] * 4, frames[0].shape[0] * 4)


def test_gif_without_pil_raises(monkeypatch, tmp_path):
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name.split(".")[0] == "PIL":
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="needs PIL"):
        demo.main(["--device", "cpu", "--gif", str(tmp_path / "x.gif"),
                   *FILES])
    assert not (tmp_path / "x.gif").exists()
