"""Checkpoints and exact resume.

Port of ``active_tracking_rl_tpu/rl/checkpoint.py``.

* Parameter files are in flax's own format (``serialization.to_bytes`` of
  the JAX package's params tree, ``utils/flax_msgpack.py``), with the JAX
  package's names: ``all-best-{it}.msgpack``, ``all-{best|new}.msgpack``
  and, with ``split``, ``{tracker,target}-{best|new}.msgpack``. Each package
  reads the other's weights. A score at or above the best so far is a new
  best.
* The resume state is the port's own, ``train_state.pt`` (``torch.save``
  under a format version; a mismatch is refused): model and optimizer state
  dicts, the whole env carry with its generator's state, the curriculum,
  the iteration and the best-score watermark after this save's score. Its
  name differs from the JAX package's ``train_state.msgpack``, so neither
  package misreads the other's.
* ``load_params`` loads a full, a tracker-only or a target-only file into a
  model.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from active_tracking_rl_torch.models.dueling import params_from_flax
from active_tracking_rl_torch.utils import flax_msgpack

#: train_state.pt format version (bump on layout changes).
TRAIN_STATE_VERSION = 1
TRAIN_STATE_FILE = "train_state.pt"


def save_file(path: str, tree: Mapping) -> None:
    """A params tree (nested dicts of numpy arrays) in flax's format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(flax_msgpack.packb(tree))


def load_file(path: str) -> Dict[str, Any]:
    """The params tree of a flax-format file."""
    with open(path, "rb") as f:
        return flax_msgpack.unpackb(f.read())


def save_train_state(log_dir: str, train_state: Dict[str, Any]) -> None:
    torch.save({"version": TRAIN_STATE_VERSION, "state": train_state},
               os.path.join(log_dir, TRAIN_STATE_FILE))


def load_train_state(log_dir: str, map_location="cpu") -> Dict[str, Any]:
    """The dict that `save_train_state` saved, tensors on `map_location`."""
    path = os.path.join(log_dir, TRAIN_STATE_FILE)
    payload = torch.load(path, map_location=map_location, weights_only=True)
    version = payload.get("version")
    if version != TRAIN_STATE_VERSION:
        raise ValueError(f"unsupported train_state version {version!r} in "
                         f"{path} (expected {TRAIN_STATE_VERSION})")
    return payload["state"]


class CheckpointManager:
    """best/latest and split tracker/target checkpoints in a log dir."""

    def __init__(self, log_dir: str, split: bool = True):
        self.log_dir = log_dir
        self.split = split
        self.max_score = -100.0
        os.makedirs(log_dir, exist_ok=True)

    def save(self, params: Mapping, train_state: Optional[Dict[str, Any]],
             score: float, n_iter: int) -> bool:
        """Write the params tree {"player0": ..., "player1": ...} and the
        resume state; returns True if `score` is a new best."""
        best = score >= self.max_score
        if best:
            self.max_score = score
            tag = "best"
            save_file(os.path.join(self.log_dir, f"all-best-{n_iter}.msgpack"),
                      params)
        else:
            tag = "new"
        save_file(os.path.join(self.log_dir, f"all-{tag}.msgpack"), params)
        if self.split:
            save_file(os.path.join(self.log_dir, f"tracker-{tag}.msgpack"),
                      params["player0"])
            if "player1" in params:
                save_file(os.path.join(self.log_dir, f"target-{tag}.msgpack"),
                          params["player1"])
        if train_state is not None:
            # the watermark after this score, so that a resumed run makes
            # the same best/new decisions as an uninterrupted one
            save_train_state(self.log_dir,
                             dict(train_state, max_score=self.max_score))
        with open(os.path.join(self.log_dir, "ckpt_meta.json"), "w") as f:
            json.dump({"max_score": self.max_score, "n_iter": n_iter}, f)
        return best

    def load_meta(self) -> Optional[Dict[str, Any]]:
        p = os.path.join(self.log_dir, "ckpt_meta.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None


def _load_players(model: nn.Module, tree: Mapping) -> None:
    """Copy the params tree of some players into `model`; every parameter
    of those players must be in the tree, with its shape."""
    new = params_from_flax(tree)
    own = {k for k in model.state_dict() if k.split(".")[0] in tree}
    if set(new) != own:
        raise ValueError(f"params do not fit the model: missing "
                         f"{sorted(own - set(new))}, unexpected "
                         f"{sorted(set(new) - own)}")
    model.load_state_dict(new, strict=False)


def load_params(model: nn.Module, load_model: Optional[str] = None,
                load_tracker: Optional[str] = None,
                load_target: Optional[str] = None) -> nn.Module:
    """Full (``all-*.msgpack``), tracker-only and target-only loading into
    `model`, in that order."""
    if load_model:
        _load_players(model, load_file(load_model))
    if load_tracker:
        _load_players(model, {"player0": load_file(load_tracker)})
    if load_target:
        _load_players(model, {"player1": load_file(load_target)})
    return model
