"""Two-player dueling model, batched.

Port of ``active_tracking_rl_tpu/models/dueling.py`` for the discrete
networks ``maze-lstm`` and ``tat-maze-lstm``: A3CPlayer is CNNMaze ->
LSTMCell -> value and policy heads. TATPlayer, the tracker-aware target,
sees the tracker's and its own observation joined on the stack axis, adds
a linear embedding of the tracker's one-hot action to the features before
the LSTM, and predicts the tracker's reward with an aux head.
``step_both`` samples the tracker, then the target, by their noise (train)
or greedily (test). Single-player models, the other encoders and cells and
continuous heads wait.

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
    r_pred: Optional[torch.Tensor] = None   # (B, 1), TATPlayer only


class A3CPlayer(nn.Module):
    """CNNMaze -> LSTMCell -> value and policy heads."""

    def __init__(self, cfg: NetConfig, num_actions: int,
                 obs_hw: Tuple[int, int], stack_frames: Optional[int] = None):
        super().__init__()
        if cfg.encoder != "maze" or cfg.rnn != "lstm" or cfg.continuous:
            raise NotImplementedError(f"network {cfg.name!r} is not ported yet")
        self.encoder = CNNMaze(obs_hw, stack_frames or cfg.stack_frames)
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


class TATPlayer(A3CPlayer):
    """The tracker-aware target: CNNMaze over 2k frames (the tracker's k,
    then its own), plus fc_action_tracker(one-hot tracker action), ->
    LSTMCell -> value, policy and reward_aux heads."""

    def __init__(self, cfg: NetConfig, num_actions: int,
                 obs_hw: Tuple[int, int]):
        super().__init__(cfg, num_actions, obs_hw, 2 * cfg.stack_frames)
        self.fc_action_tracker = nn.Linear(num_actions, self.encoder.out_dim)
        self.reward_aux = nn.Linear(cfg.rnn_out, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        init_linear_(self.fc_action_tracker, generator)
        init_linear_(self.reward_aux, generator)

    def forward(self, obs: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                action_tracker: torch.Tensor) -> PlayerOut:
        feat = self.encoder(obs) + self.fc_action_tracker(action_tracker)
        h, c = self.lstm(feat, h, c)
        return PlayerOut(self.value(h), self.policy(h), h, c,
                         self.reward_aux(h))


class DuelingModel(nn.Module):
    """player0 (tracker) and player1 (target) in one module."""

    def __init__(self, net_cfg: NetConfig, num_actions: int,
                 obs_hw: Tuple[int, int]):
        super().__init__()
        self.cfg = net_cfg
        self.num_actions = num_actions
        self.player0 = A3CPlayer(net_cfg, num_actions, obs_hw)
        self.player1 = (TATPlayer if net_cfg.tat else A3CPlayer)(
            net_cfg, num_actions, obs_hw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.player0.reset_parameters(generator)
        self.player1.reset_parameters(generator)

    def tracker_fwd(self, obs0, h0, c0) -> PlayerOut:
        return self.player0(obs0, h0, c0)

    def target_fwd(self, obs0, obs1, h1, c1, tracker_action) -> PlayerOut:
        """A TAT target sees both observations, joined on the stack axis,
        and the tracker's action one-hot; a plain one only its own
        observation."""
        if self.cfg.tat:
            a2t = torch.nn.functional.one_hot(
                tracker_action.long(), self.num_actions).to(obs1.dtype)
            return self.player1(torch.cat([obs0, obs1], dim=1), h1, c1, a2t)
        return self.player1(obs1, h1, c1)

    def sample(self, out: PlayerOut, gumbel: Optional[torch.Tensor],
               test: bool = False) -> ActionSample:
        return sample_discrete(out.logits, gumbel, test)

    def step_both(self, obs: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor,
                  gumbel: Optional[torch.Tensor], test: bool = False):
        """Joint forward: the tracker acts, then the target.

        obs (B, 2, k, H, W, 1) float; hx, cx (B, 2, R); gumbel (B, 2, A) the
        sampling noise of each player (train), unread and may be None when
        `test` picks each player's most probable action. Returns (values
        (B,2), actions (B,2), entropies (B,2), log_probs (B,2), hx', cx',
        r_pred (B,1) of a TAT target or None).
        """
        g0, g1 = (None, None) if gumbel is None else gumbel.unbind(1)
        out0 = self.tracker_fwd(obs[:, 0], hx[:, 0], cx[:, 0])
        s0 = self.sample(out0, g0, test)
        out1 = self.target_fwd(obs[:, 0], obs[:, 1], hx[:, 1], cx[:, 1],
                               s0.action)
        s1 = self.sample(out1, g1, test)
        return (torch.cat([out0.value, out1.value], dim=-1),
                torch.stack([s0.action, s1.action], dim=-1),
                torch.cat([s0.entropy, s1.entropy], dim=-1),
                torch.cat([s0.log_prob, s1.log_prob], dim=-1),
                torch.stack([out0.h, out1.h], dim=1),
                torch.stack([out0.c, out1.c], dim=1),
                out1.r_pred)


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
# TATPlayer's named Dense layers: the same names in both packages
_TAT_NAMES = ("fc_action_tracker", "reward_aux")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params {"player0": ..., "player1": ...} -> DuelingModel state_dict."""
    out = {}

    def put(name: str, leaf: Mapping) -> None:
        kernel = np.asarray(leaf["kernel"])
        if kernel.ndim == 4:                           # HWIO -> OIHW
            weight = kernel.transpose(3, 2, 0, 1)
        else:                                          # (in, out) -> (out, in)
            weight = kernel.T
        out[f"{name}.weight"] = torch.tensor(weight)
        out[f"{name}.bias"] = torch.tensor(np.asarray(leaf["bias"]))

    for player, tree in params.items():
        for (outer, inner), name in _FLAX_NAMES.items():
            put(f"{player}.{name}", tree[outer][inner])
        for name in _TAT_NAMES:
            if name in tree:
                put(f"{player}.{name}", tree[name])
        for flax_name, name in _LSTM_NAMES.items():
            w = np.asarray(tree["LSTMCell_0"][flax_name])
            out[f"{player}.lstm.{name}"] = torch.tensor(w.T if w.ndim == 2
                                                        else w)
    return out
