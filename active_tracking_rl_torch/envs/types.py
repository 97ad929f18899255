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


def zeros_like_state(cfg, device="cuda") -> EnvState:
    """A template EnvState of one row with the right shapes and dtypes:
    an all-wall map, the rest zeros (`cfg` is an EnvConfig)."""
    s = cfg.maze_size + 2 * cfg.pob_size
    n = cfg.num_agents

    def zeros(shape, dtype):
        return torch.zeros((1, *shape), dtype=dtype, device=device)

    return EnvState(
        maze=torch.ones((1, s, s), dtype=torch.uint8, device=device),
        pos=zeros((n, 2), torch.int32),
        tape=zeros((cfg.tape_len,), torch.int8),
        t=zeros((), torch.int32),
        c_far=zeros((), torch.int32),
        done=zeros((), torch.bool),
        c_reward=zeros((n,), torch.float32),
        c_collision=zeros((n,), torch.int32),
        dist=zeros((), torch.float32),
    )


def info_dict(state: EnvState) -> Dict[str, torch.Tensor]:
    """Step info (distance, collisions, episode length)."""
    return {"distance": state.dist, "collision": state.c_collision,
            "eps_len": state.t}
