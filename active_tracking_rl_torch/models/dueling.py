"""Two-player dueling model, batched.

Port of ``active_tracking_rl_tpu/models/dueling.py`` for every discrete
network ``{tat-}?{cnn|icml|maze}{-lstm|-gru}?``: A3CPlayer is an encoder
(CNNMaze, ICML or CNNSimple) -> an LSTM or GRU cell, or none -> value and
policy heads. TATPlayer, the tracker-aware target, sees the tracker's and
its own observation joined on the stack axis, adds a linear embedding of
the tracker's one-hot action to the features before the cell, and predicts
the tracker's reward with an aux head. ``step_both`` samples the tracker,
then the target, by their noise (train) or greedily (test).

Continuous networks (``NetConfig.continuous``, the ``-continuous`` names)
have two policy heads: mu = softsign(policy(x)) and sigma_raw = sigma(x);
a continuous TAT target's ``fc_action_tracker`` takes the tracker's clamped
A-dim action itself, not a one-hot. A single-player model
(``DuelingModel(single=True)``, for host envs with one agent) has no
``player1``.

With ``NetConfig.bf16`` the encoder computes in bfloat16 (flax's
``dtype``: bias adds and relus too) and the cell's matmuls take bfloat16
inputs; parameters, heads, features and the recurrent state stay float32.

``params_from_flax`` converts the JAX package's params (flax tree of numpy
arrays) into this module's ``state_dict``: Dense kernels are (in, out) and
become (out, in); conv kernels are HWIO and become OIHW; cell weights
(in, gates * H) become (gates * H, in). ``params_to_flax`` is its inverse.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.models.encoders import FLAX_NAMES, make_encoder
from active_tracking_rl_torch.models.heads import (ActionSample,
                                                   sample_continuous,
                                                   sample_discrete)
from active_tracking_rl_torch.models.init import init_linear_
from active_tracking_rl_torch.models.recurrent import GRUCell, LSTMCell
from active_tracking_rl_torch.ops.noise import Threefry

#: cfg.rnn -> the cell; the player holds it under that name
CELLS = {"lstm": LSTMCell, "gru": GRUCell}


class PlayerOut(NamedTuple):
    value: torch.Tensor             # (B, 1)
    logits: torch.Tensor            # (B, A) discrete; mu for continuous
    h: torch.Tensor                 # (B, R)
    c: torch.Tensor                 # (B, R)
    r_pred: Optional[torch.Tensor] = None   # (B, 1), TATPlayer only
    sigma: Optional[torch.Tensor] = None    # (B, A) sigma_raw, continuous only


class A3CPlayer(nn.Module):
    """Encoder -> LSTM or GRU cell (or none) -> value and policy heads (and
    the sigma head of a continuous network)."""

    def __init__(self, cfg: NetConfig, num_actions: int,
                 obs_hw: Tuple[int, int], stack_frames: Optional[int] = None):
        super().__init__()
        self.encoder = make_encoder(cfg.encoder, obs_hw,
                                    stack_frames or cfg.stack_frames, cfg.bf16)
        self.rnn = cfg.rnn
        head_in = self.encoder.out_dim
        if cfg.rnn != "none":
            setattr(self, cfg.rnn, CELLS[cfg.rnn](self.encoder.out_dim,
                                                  cfg.rnn_out, cfg.bf16))
            head_in = cfg.rnn_out
        self.value = nn.Linear(head_in, 1)
        self.policy = nn.Linear(head_in, num_actions)
        self.sigma = (nn.Linear(head_in, num_actions) if cfg.continuous
                      else None)

    @property
    def cell(self) -> Optional[nn.Module]:
        return None if self.rnn == "none" else getattr(self, self.rnn)

    def reset_parameters(self, generator: Threefry) -> None:
        self.encoder.reset_parameters(generator)
        if self.cell is not None:
            self.cell.reset_parameters(generator)
        init_linear_(self.value, generator)
        init_linear_(self.policy, generator)
        if self.sigma is not None:
            init_linear_(self.sigma, generator)

    def core(self, feat: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """The cell on the features -> (head input, h', c'); without a cell
        the features go to the heads and h, c pass through."""
        if self.cell is None:
            return feat, h, c
        h, c = self.cell(feat, h, c)
        return h, h, c

    def heads(self, feat: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              r_pred: Optional[torch.Tensor] = None) -> PlayerOut:
        """Value and policy (softsign mu and sigma_raw if continuous)."""
        if self.sigma is None:
            return PlayerOut(self.value(feat), self.policy(feat), h, c,
                             r_pred)
        return PlayerOut(self.value(feat), F.softsign(self.policy(feat)), h,
                         c, r_pred, self.sigma(feat))

    def forward(self, obs: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor) -> PlayerOut:
        feat, h, c = self.core(self.encoder(obs), h, c)
        return self.heads(feat, h, c)


class TATPlayer(A3CPlayer):
    """The tracker-aware target: the encoder over 2k frames (the tracker's
    k, then its own), plus fc_action_tracker(tracker action: one-hot, or
    the clamped continuous action), -> the cell -> value, policy and
    reward_aux heads."""

    def __init__(self, cfg: NetConfig, num_actions: int,
                 obs_hw: Tuple[int, int]):
        super().__init__(cfg, num_actions, obs_hw, 2 * cfg.stack_frames)
        self.fc_action_tracker = nn.Linear(num_actions, self.encoder.out_dim)
        self.reward_aux = nn.Linear(self.value.in_features, 1)

    def reset_parameters(self, generator: Threefry) -> None:
        super().reset_parameters(generator)
        init_linear_(self.fc_action_tracker, generator)
        init_linear_(self.reward_aux, generator)

    def forward(self, obs: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                action_tracker: torch.Tensor) -> PlayerOut:
        feat = self.encoder(obs) + self.fc_action_tracker(action_tracker)
        feat, h, c = self.core(feat, h, c)
        return self.heads(feat, h, c, self.reward_aux(feat))


class DuelingModel(nn.Module):
    """player0 (tracker) and player1 (target) in one module; a single-player
    model has player1 None."""

    def __init__(self, net_cfg: NetConfig, num_actions: int,
                 obs_hw: Tuple[int, int], single: bool = False):
        super().__init__()
        self.cfg = net_cfg
        self.num_actions = num_actions
        self.player0 = A3CPlayer(net_cfg, num_actions, obs_hw)
        self.player1 = None if single else (
            TATPlayer if net_cfg.tat else A3CPlayer)(net_cfg, num_actions,
                                                     obs_hw)

    def reset_parameters(self, generator: Threefry) -> None:
        self.player0.reset_parameters(generator)
        if self.player1 is not None:
            self.player1.reset_parameters(generator)

    def tracker_fwd(self, obs0, h0, c0) -> PlayerOut:
        return self.player0(obs0, h0, c0)

    def target_fwd(self, obs0, obs1, h1, c1, tracker_action) -> PlayerOut:
        """A TAT target sees both observations, joined on the stack axis,
        and the tracker's action: one-hot (discrete, (B,) int) or as it is
        (continuous, (B, A) float, clamped by the caller); a plain target
        only its own observation."""
        if self.cfg.tat:
            if self.cfg.continuous:
                a2t = tracker_action
            else:
                a2t = F.one_hot(tracker_action.long(),
                                self.num_actions).to(obs1.dtype)
            return self.player1(torch.cat([obs0, obs1], dim=1), h1, c1, a2t)
        return self.player1(obs1, h1, c1)

    def sample(self, out: PlayerOut, noise: Optional[torch.Tensor],
               test: bool = False) -> ActionSample:
        """`noise` (B, A): Gumbel (discrete) or standard normal
        (continuous)."""
        if self.cfg.continuous:
            return sample_continuous(out.logits, out.sigma, noise, test)
        return sample_discrete(out.logits, noise, test)

    def step_both(self, obs: torch.Tensor, hx: torch.Tensor, cx: torch.Tensor,
                  noise: Optional[torch.Tensor], test: bool = False):
        """Joint forward: the tracker acts, then the target.

        obs (B, P, k, H, W, 1) float; hx, cx (B, P, R), P = 2 (P = 1 for a
        single-player model); noise (B, P, A) each player's sampling noise
        (Gumbel, or standard normal for continuous heads), unread and may be
        None when `test` picks each discrete player's most probable action.
        Returns (values (B,P), actions, entropies (B,P), log_probs (B,P),
        hx', cx', r_pred (B,1) of a TAT target or None). Discrete actions
        are (B, P) int64; continuous ones the raw samples (B, P, A), whose
        entropy and log-probability are meaned over the action dims.
        """
        n0, n1 = (None, None) if noise is None else (noise[:, 0],
                                                     noise[:, -1])
        out0 = self.tracker_fwd(obs[:, 0], hx[:, 0], cx[:, 0])
        s0 = self.sample(out0, n0, test)
        samples, outs = [s0], [out0]
        if self.player1 is not None:
            out1 = self.target_fwd(obs[:, 0], obs[:, 1], hx[:, 1], cx[:, 1],
                                   s0.action)
            samples.append(self.sample(out1, n1, test))
            outs.append(out1)
        cont = self.cfg.continuous

        def stat(x):
            return x.mean(-1, keepdim=True) if cont else x

        actions = [s.raw_action if cont else s.action for s in samples]
        return (torch.cat([o.value for o in outs], dim=-1),
                torch.stack(actions, dim=1),
                torch.cat([stat(s.entropy) for s in samples], dim=-1),
                torch.cat([stat(s.log_prob) for s in samples], dim=-1),
                torch.stack([o.h for o in outs], dim=1),
                torch.stack([o.c for o in outs], dim=1),
                outs[1].r_pred if len(outs) == 2 else None)


def build_model(net_cfg: NetConfig, num_actions: int, obs_hw: Tuple[int, int],
                device="cuda", generator: Optional[Threefry] = None,
                single: bool = False) -> DuelingModel:
    """The model on `device`, initialized from `generator` when one is given."""
    model = DuelingModel(net_cfg, num_actions, obs_hw, single).to(device)
    if generator is not None:
        model.reset_parameters(generator)
    return model


# flax module names of a player's layers, other than the encoder's
_FLAX_DENSE = {("ValueNet_0", "Dense_0"): "value",
               ("PolicyNet_0", "Dense_0"): "policy",
               ("PolicyNet_0", "Dense_1"): "sigma",
               ("fc_action_tracker",): "fc_action_tracker",
               ("reward_aux",): "reward_aux"}
_FLAX_CELLS = {"LSTMCell_0": "lstm", "GRUCell_0": "gru"}
_CELL_NAMES = {"w_ih": "weight_ih", "w_hh": "weight_hh",
               "b_ih": "bias_ih", "b_hh": "bias_hh"}
_ENCODERS = {v: k for k, v in FLAX_NAMES.items()}


def _player_names(tree: Mapping) -> Dict[Tuple[str, ...], str]:
    """flax path -> torch module path, for one player's tree: every Conv_i
    and Dense_0 of its encoder, its cell and its Dense layers."""
    names = {}
    for outer, sub in tree.items():
        if outer in _ENCODERS:
            for inner in sub:
                names[(outer, inner)] = "encoder." + (
                    "fc" if inner == "Dense_0"
                    else "conv" + inner[len("Conv_"):])
        elif outer in _FLAX_CELLS:
            names[(outer,)] = _FLAX_CELLS[outer]
    for path, name in _FLAX_DENSE.items():
        node = tree
        for part in path:
            node = node.get(part, {})
        if node:
            names[path] = name
    return names


def _get(tree: Mapping, path: Tuple[str, ...]) -> Mapping:
    for part in path:
        tree = tree[part]
    return tree


def _to_torch(x: np.ndarray) -> torch.Tensor:
    if x.ndim == 4:                           # HWIO -> OIHW
        x = x.transpose(3, 2, 0, 1)
    elif x.ndim == 2:                         # (in, out) -> (out, in)
        x = x.T
    return torch.tensor(np.ascontiguousarray(x))


def _to_flax(t: torch.Tensor) -> np.ndarray:
    x = t.detach().cpu().numpy()
    if x.ndim == 4:                           # OIHW -> HWIO
        x = x.transpose(2, 3, 1, 0)
    elif x.ndim == 2:
        x = x.T
    return np.ascontiguousarray(x)


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params {"player0": ..., "player1": ...} (either player alone, too)
    -> DuelingModel state_dict entries."""
    out = {}
    for player, tree in params.items():
        for path, name in _player_names(tree).items():
            leaf = _get(tree, path)
            if name in _FLAX_CELLS.values():
                for flax_name, torch_name in _CELL_NAMES.items():
                    out[f"{player}.{name}.{torch_name}"] = _to_torch(
                        np.asarray(leaf[flax_name]))
            else:
                out[f"{player}.{name}.weight"] = _to_torch(
                    np.asarray(leaf["kernel"]))
                out[f"{player}.{name}.bias"] = _to_torch(
                    np.asarray(leaf["bias"]))
    return out


def params_to_flax(state_dict: Mapping[str, torch.Tensor],
                   net_cfg: NetConfig) -> Dict[str, Dict]:
    """DuelingModel state_dict (or entries of either player) -> the JAX
    package's params tree of numpy arrays, the inverse of
    ``params_from_flax``."""
    cells = {v: k for k, v in _FLAX_CELLS.items()}
    dense = {v: k for k, v in _FLAX_DENSE.items()}
    leaves = {v: k for k, v in _CELL_NAMES.items()}
    out: Dict[str, Dict] = {}
    for key, value in state_dict.items():
        player, *mod, leaf = key.split(".")
        if mod[0] == "encoder":
            inner = ("Dense_0" if mod[1] == "fc"
                     else "Conv_" + mod[1][len("conv"):])
            path = (FLAX_NAMES[net_cfg.encoder], inner)
        elif mod[0] in cells:
            path = (cells[mod[0]],)
        else:
            path = dense[mod[0]]
        if mod[0] in cells:
            name = leaves[leaf]
        else:
            name = "kernel" if leaf == "weight" else "bias"
        node = out.setdefault(player, {})
        for part in path:
            node = node.setdefault(part, {})
        node[name] = _to_flax(value)
    return _sorted(out)


def _sorted(tree):
    """Keys in sorted order at every level, as in a JAX params tree."""
    if not isinstance(tree, dict):
        return tree
    return {k: _sorted(tree[k]) for k in sorted(tree)}
