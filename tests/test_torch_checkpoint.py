"""The port's checkpoint files (active_tracking_rl_torch/rl/checkpoint.py and
utils/flax_msgpack.py) against flax's serialization and the JAX package's
``rl/checkpoint.py``.

* The port's decoder reads every parameter file under runs/ as
  ``flax.serialization.msgpack_restore`` does: the same tree, and each
  array's dtype, shape and bytes; its encoder writes those files' bytes
  back.
* A parameter file the port writes is read by the JAX package's
  ``load_file`` against its model's template, bit for bit, and is the bytes
  of ``flax.serialization.to_bytes``.
* The checkpoint manager writes the JAX package's file names, its resume
  state keeps the watermark after the save's score, and a resume state of
  another format version is refused (as tests/test_resume.py holds the JAX
  manager).
* ``load_params`` loads full, tracker-only and target-only files.
All comparisons are exact.
"""

import glob
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import tests.torch_draws  # noqa: F401  (one CPU thread for torch)
from active_tracking_rl_tpu.config import NetConfig as JNetConfig
from active_tracking_rl_tpu.models.dueling import build_model as jbuild
from active_tracking_rl_tpu.rl.checkpoint import load_file as j_load_file
from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.models.dueling import build_model, params_to_flax
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.checkpoint import (TRAIN_STATE_FILE,
                                                    CheckpointManager,
                                                    load_file, load_params,
                                                    load_train_state,
                                                    save_file)
from active_tracking_rl_torch.utils import flax_msgpack

ROOT = Path(__file__).resolve().parents[1]
RAM = ROOT / "runs/r3-tracker-ram/Track2D-BlockPartialRam-v0/Aug21_00-06"


def _assert_same(got, want, path=""):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


def test_decoder_reads_every_run_file_as_flax_does():
    files = sorted(glob.glob(str(ROOT / "runs/**/*.msgpack"), recursive=True))
    assert len(files) >= 40
    for f in files:
        data = Path(f).read_bytes()
        got = flax_msgpack.unpackb(data)
        _assert_same(got, serialization.msgpack_restore(data), f)
        assert flax_msgpack.packb(got) == data, f


def test_codec_scalars_and_lengths():
    """Every msgpack width the encoder picks round-trips, as flax's
    msgpack reads it."""
    tree = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32,
                     -33, -128, -129, -32768, -32769, -2**31 - 1],
            "floats": [0.5, -1e300], "flags": [True, False, None],
            "str": ["", "x" * 31, "y" * 32, "z" * 300, "ü"],
            "bin": [b"", b"a" * 300],
            "many": list(range(20)), "wide": {f"k{i}": i for i in range(20)},
            "arrays": {"f": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": np.array([True, False]), "e": np.zeros((0, 4)),
                       "u": np.arange(300, dtype=np.uint8)}}
    data = flax_msgpack.packb(tree)
    want = serialization.msgpack_restore(data)
    _assert_same(flax_msgpack.unpackb(data), want)
    assert serialization.msgpack_serialize(want) == data


@pytest.mark.parametrize("name", ["tat-maze-lstm", "icml-gru", "tat-cnn"])
def test_jax_reads_the_port_parameter_files(tmp_path, name):
    hw = (82, 82) if "cnn" in name else (13, 13)
    model = build_model(NetConfig.from_name(name), 4, hw, device="cpu",
                        generator=Threefry().manual_seed(5))
    params = params_to_flax(model.state_dict(), model.cfg)
    ckpt = CheckpointManager(str(tmp_path), split=True)
    assert ckpt.save(params, None, score=1.0, n_iter=3)
    jm = jbuild(JNetConfig.from_name(name), 4, hw)
    template = jax.tree_util.tree_map(np.asarray,
                                      jm.init(jax.random.PRNGKey(0)))
    full = j_load_file(str(tmp_path / "all-best.msgpack"), template)
    _assert_same(jax.tree_util.tree_map(np.asarray, full), params)
    tracker = j_load_file(str(tmp_path / "tracker-best.msgpack"),
                          template["player0"])
    _assert_same(jax.tree_util.tree_map(np.asarray, tracker),
                 params["player0"])
    assert (tmp_path / "all-best.msgpack").read_bytes() == \
        serialization.to_bytes(params)


def test_manager_file_names_and_watermark(tmp_path):
    """The names of the JAX manager; the resume state's watermark is the
    one after this save's score (mirrors tests/test_resume.py)."""
    model = build_model(NetConfig.from_name("tat-maze-lstm"), 4, (13, 13),
                        device="cpu")
    params = params_to_flax(model.state_dict(), model.cfg)
    ckpt = CheckpointManager(str(tmp_path), split=True)
    assert ckpt.save(params, {"step": 1}, score=3.5, n_iter=1)
    assert load_train_state(str(tmp_path))["max_score"] == 3.5
    assert not ckpt.save(params, {"step": 2}, score=-9.0, n_iter=2)
    assert load_train_state(str(tmp_path))["max_score"] == 3.5  # not lowered
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([
        "all-best-1.msgpack", "all-best.msgpack", "all-new.msgpack",
        "tracker-best.msgpack", "tracker-new.msgpack", "target-best.msgpack",
        "target-new.msgpack", "ckpt_meta.json", TRAIN_STATE_FILE])
    assert json.loads((tmp_path / "ckpt_meta.json").read_text()) == {
        "max_score": 3.5, "n_iter": 2}
    assert ckpt.load_meta()["n_iter"] == 2
    unsplit = CheckpointManager(str(tmp_path / "unsplit"), split=False)
    unsplit.save(params, None, score=0.0, n_iter=1)
    assert not list((tmp_path / "unsplit").glob("tracker-*"))


def test_version_mismatch_rejected(tmp_path):
    torch.save({"version": 999, "state": {}}, tmp_path / TRAIN_STATE_FILE)
    with pytest.raises(ValueError, match="version"):
        load_train_state(str(tmp_path))


def test_load_params_full_tracker_and_target(tmp_path):
    """The committed Ram tracker into player0 only; then a full file into
    both players; a file of another network is refused."""
    net = NetConfig.from_name("tat-maze-lstm")
    model = build_model(net, 4, (13, 13), device="cpu",
                        generator=Threefry().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_params(model, load_tracker=str(RAM / "tracker-best.msgpack"))
    tracker = load_file(str(RAM / "tracker-best.msgpack"))
    _assert_same(params_to_flax(model.state_dict(), net)["player0"], tracker)
    assert all(torch.equal(model.state_dict()[k], v)
               for k, v in before.items() if k.startswith("player1"))

    other = build_model(net, 4, (13, 13), device="cpu",
                        generator=Threefry().manual_seed(1))
    save_file(str(tmp_path / "all.msgpack"),
              params_to_flax(other.state_dict(), net))
    load_params(model, load_model=str(tmp_path / "all.msgpack"))
    assert all(torch.equal(model.state_dict()[k], v)
               for k, v in other.state_dict().items())
    load_params(model, load_target=str(RAM / "target-best.msgpack"))

    gru = build_model(NetConfig.from_name("tat-maze-gru"), 4, (13, 13),
                      device="cpu")
    with pytest.raises(ValueError, match="missing"):
        load_params(gru, load_tracker=str(RAM / "tracker-best.msgpack"))
