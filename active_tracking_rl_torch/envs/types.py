"""Environment state: a struct of batched tensors.

The fields are those of ``active_tracking_rl_tpu/envs/types.py:EnvState``
with a leading row dimension N on every field (the JAX state is single-row
and batched with vmap).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch


@dataclasses.dataclass
class EnvState:
    #: wall map padded with `pob_size` wall cells per side, (N, S+2p, S+2p) uint8.
    maze: torch.Tensor
    #: agent positions in unpadded (row, col), (N, 2, 2) int32.
    pos: torch.Tensor
    #: scripted-target action tape, (N, tape_len) int8 (zeros for dueling modes).
    tape: torch.Tensor
    #: steps taken in this episode, (N,) int32.
    t: torch.Tensor
    #: consecutive steps with distance > pob_size, (N,) int32.
    c_far: torch.Tensor
    #: episode terminated (lost target or time limit), (N,) bool.
    done: torch.Tensor
    #: cumulative per-agent reward, (N, 2) float32.
    c_reward: torch.Tensor
    #: cumulative wall collisions per agent, (N, 2) int32.
    c_collision: torch.Tensor
    #: tracker-target euclidean distance after the last step, (N,) float32.
    dist: torch.Tensor

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "EnvState":
        """Apply `fn` to every field."""
        return EnvState(**{f.name: fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})

    def zip_map(self, fn, other: "EnvState") -> "EnvState":
        """fn(self.field, other.field) for every field."""
        return EnvState(**{f.name: fn(getattr(self, f.name),
                                      getattr(other, f.name))
                           for f in dataclasses.fields(self)})

    @property
    def num_rows(self) -> int:
        return self.t.shape[0]


def info_dict(state: EnvState) -> Dict[str, torch.Tensor]:
    """Step info (distance, collisions, episode length)."""
    return {"distance": state.dist, "collision": state.c_collision,
            "eps_len": state.t}
