"""Two-player dueling model, batched.

Port of ``active_tracking_rl_tpu/models/dueling.py`` for the discrete
non-TAT network ``maze-lstm``: A3CPlayer is CNNMaze -> LSTMCell -> value and
policy heads. ``step_both`` samples the tracker, then the target. TATPlayer,
single-player models, the other encoders and cells, continuous heads and
greedy (test) stepping wait.

``params_from_flax`` converts the JAX package's params (flax tree of numpy
arrays) into this module's ``state_dict``: Dense kernels are (in, out) and
become (out, in); conv kernels are HWIO and become OIHW.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.models.encoders import CNNMaze
from active_tracking_rl_torch.models.heads import ActionSample, sample_discrete
from active_tracking_rl_torch.models.init import init_linear_
from active_tracking_rl_torch.models.recurrent import LSTMCell


class PlayerOut(NamedTuple):
    value: torch.Tensor             # (B, 1)
    logits: torch.Tensor            # (B, A)
    h: torch.Tensor                 # (B, R)
    c: torch.Tensor                 # (B, R)


class A3CPlayer(nn.Module):
    """CNNMaze -> LSTMCell -> value and policy heads."""

    def __init__(self, cfg: NetConfig, num_actions: int,
                 obs_hw: Tuple[int, int]):
        super().__init__()
        if cfg.encoder != "maze" or cfg.rnn != "lstm" or cfg.continuous:
            raise NotImplementedError(f"network {cfg.name!r} is not ported yet")
        self.encoder = CNNMaze(obs_hw, cfg.stack_frames)
        self.lstm = LSTMCell(self.encoder.out_dim, cfg.rnn_out)
        self.value = nn.Linear(cfg.rnn_out, 1)
        self.policy = nn.Linear(cfg.rnn_out, num_actions)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.encoder.reset_parameters(generator)
        self.lstm.reset_parameters(generator)
        init_linear_(self.value, generator)
        init_linear_(self.policy, generator)

    def forward(self, obs: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor) -> PlayerOut:
        h, c = self.lstm(self.encoder(obs), h, c)
        return PlayerOut(self.value(h), self.policy(h), h, c)


class DuelingModel(nn.Module):
    """player0 (tracker) and player1 (target) in one module."""

    def __init__(self, net_cfg: NetConfig, num_actions: int,
                 obs_hw: Tuple[int, int]):
        super().__init__()
        if net_cfg.tat:
            raise NotImplementedError("TATPlayer is not ported yet")
        self.cfg = net_cfg
        self.num_actions = num_actions
        self.player0 = A3CPlayer(net_cfg, num_actions, obs_hw)
        self.player1 = A3CPlayer(net_cfg, num_actions, obs_hw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.player0.reset_parameters(generator)
        self.player1.reset_parameters(generator)

    def tracker_fwd(self, obs0, h0, c0) -> PlayerOut:
        return self.player0(obs0, h0, c0)

    def target_fwd(self, obs0, obs1, h1, c1, tracker_action) -> PlayerOut:
        """A non-TAT target sees only its own observation."""
        del obs0, tracker_action
        return self.player1(obs1, h1, c1)

    def sample(self, out: PlayerOut, gumbel: torch.Tensor) -> ActionSample:
        return sample_discrete(out.logits, gumbel)

    def step_both(self, obs: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor,
                  gumbel: torch.Tensor):
        """Joint forward: the tracker samples, then the target.

        obs (B, 2, k, H, W, 1) float; hx, cx (B, 2, R); gumbel (B, 2, A) the
        sampling noise of each player. Returns (values (B,2), actions (B,2),
        entropies (B,2), log_probs (B,2), hx', cx').
        """
        out0 = self.tracker_fwd(obs[:, 0], hx[:, 0], cx[:, 0])
        s0 = self.sample(out0, gumbel[:, 0])
        out1 = self.target_fwd(obs[:, 0], obs[:, 1], hx[:, 1], cx[:, 1],
                               s0.action)
        s1 = self.sample(out1, gumbel[:, 1])
        return (torch.cat([out0.value, out1.value], dim=-1),
                torch.stack([s0.action, s1.action], dim=-1),
                torch.cat([s0.entropy, s1.entropy], dim=-1),
                torch.cat([s0.log_prob, s1.log_prob], dim=-1),
                torch.stack([out0.h, out1.h], dim=1),
                torch.stack([out0.c, out1.c], dim=1))


def build_model(net_cfg: NetConfig, num_actions: int, obs_hw: Tuple[int, int],
                device="cuda",
                generator: Optional[torch.Generator] = None) -> DuelingModel:
    """The model on `device`, initialized from `generator` when one is given."""
    model = DuelingModel(net_cfg, num_actions, obs_hw).to(device)
    if generator is not None:
        model.reset_parameters(generator)
    return model


# flax module path -> this package's module path, per player
_FLAX_NAMES = {
    ("CNNMaze_0", "Conv_0"): "encoder.conv0",
    ("CNNMaze_0", "Conv_1"): "encoder.conv1",
    ("CNNMaze_0", "Dense_0"): "encoder.fc",
    ("ValueNet_0", "Dense_0"): "value",
    ("PolicyNet_0", "Dense_0"): "policy",
}
_LSTM_NAMES = {"w_ih": "weight_ih", "w_hh": "weight_hh",
               "b_ih": "bias_ih", "b_hh": "bias_hh"}


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params {"player0": ..., "player1": ...} -> DuelingModel state_dict."""
    out = {}
    for player, tree in params.items():
        for (outer, inner), name in _FLAX_NAMES.items():
            leaf = tree[outer][inner]
            kernel = np.asarray(leaf["kernel"])
            if kernel.ndim == 4:                       # HWIO -> OIHW
                weight = kernel.transpose(3, 2, 0, 1)
            else:                                      # (in, out) -> (out, in)
                weight = kernel.T
            out[f"{player}.{name}.weight"] = torch.tensor(weight)
            out[f"{player}.{name}.bias"] = torch.tensor(np.asarray(leaf["bias"]))
        for flax_name, name in _LSTM_NAMES.items():
            w = np.asarray(tree["LSTMCell_0"][flax_name])
            out[f"{player}.lstm.{name}"] = torch.tensor(w.T if w.ndim == 2
                                                        else w)
    return out
