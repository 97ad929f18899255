"""The port's random agent (``run/random_agent.py``) on the CPU at
a tiny size: the FPS mode on a Nav id (reset, then 20-step blocks), and
the episode mode with and without a GIF; its flags are the JAX script's
plus --device.
"""

import argparse

import numpy as np
import pytest

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_torch.run import random_agent


class _Parsed(Exception):
    pass


def test_flags_are_the_jax_scripts_plus_device(monkeypatch):
    """The JAX script builds its parser inside main: catch it there."""
    from active_tracking_rl_tpu.run import random_agent as jra

    def grab(parser, argv=None):
        raise _Parsed(parser)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as caught:
        jra.main([])
    jax_flags = {(tuple(a.option_strings), a.default)
                 for a in caught.value.args[0]._actions}
    port = {(tuple(a.option_strings), a.default)
            for a in random_agent.build_argparser()._actions}
    assert port - jax_flags == {(("--device",), "cuda")}
    assert jax_flags <= port


def test_fps_mode_on_nav(capsys):
    out = random_agent.main(["--device", "cpu", "-e",
                             "Track2D-BlockPartialNav-v0", "--num-envs", "4",
                             "--seconds", "0.2"])
    assert out["blocks"] >= 1 and out["fps"] > 0
    assert out["seconds"] >= 0.2
    assert "env-steps/s (4 envs x 20-step blocks, cpu)" in \
        capsys.readouterr().out


@pytest.mark.parametrize("gif", [False, True])
def test_episode_mode(tmp_path, capsys, gif):
    path = tmp_path / "ep.gif"
    argv = ["--device", "cpu", "-e", "Track2D-EmptyPartialRam-v0",
            "--episodes", "2"]
    if gif:
        pytest.importorskip("PIL")
        argv += ["--gif", str(path)]
    eps = random_agent.main(argv)
    text = capsys.readouterr().out
    assert len(eps) == 2
    for i, (length, rewards) in enumerate(eps):
        assert 1 <= length <= 500 and rewards.shape == (2,)
        assert np.isfinite(rewards).all()
        assert f"episode {i}: len {length}" in text
    assert path.exists() == gif
    if gif:
        assert f"wrote {eps[0][0]} frames" in text
