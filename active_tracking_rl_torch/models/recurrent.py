"""LSTM and GRU cells with torch's gate semantics, written out.

Port of ``active_tracking_rl_tpu/models/recurrent.py``. The parameters have
``nn.LSTMCell``'s and ``nn.GRUCell``'s names and shapes; the arithmetic is
the JAX modules', in their order. Both keep the ``(h, c)`` interface; the
GRU has no cell state and passes ``c`` through unchanged.

With ``bf16`` the two matmuls take bfloat16 inputs and weights; their
results go back to float32 before the bias adds and gate nonlinearities.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from active_tracking_rl_torch.models.init import torch_rnn_uniform_
from active_tracking_rl_torch.ops.noise import Threefry


def matmul(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """x @ w.T, with bfloat16 inputs and a float32 result under `bf16`."""
    if not bf16:
        return x @ w.t()
    return (x.to(torch.bfloat16) @ w.to(torch.bfloat16).t()).to(torch.float32)


class _Cell(nn.Module):
    """Weights (gates * hidden, in) and (gates * hidden, hidden), zero biases."""

    gates = 0

    def __init__(self, input_size: int, hidden: int, bf16: bool = False):
        super().__init__()
        self.hidden = hidden
        self.bf16 = bf16
        g = self.gates * hidden
        self.weight_ih = nn.Parameter(torch.empty(g, input_size))
        self.weight_hh = nn.Parameter(torch.empty(g, hidden))
        self.bias_ih = nn.Parameter(torch.zeros(g))
        self.bias_hh = nn.Parameter(torch.zeros(g))
        # drawn now from a generator of key (0, 0), so that a model built
        # without a generator holds no uninitialized memory
        self.reset_parameters(Threefry())

    def reset_parameters(self, generator) -> None:
        torch_rnn_uniform_(self.weight_ih, self.hidden, generator)
        torch_rnn_uniform_(self.weight_hh, self.hidden, generator)
        nn.init.zeros_(self.bias_ih)
        nn.init.zeros_(self.bias_hh)


class LSTMCell(_Cell):
    """Gates [i, f, g, o] from x W_ih^T + b_ih + h W_hh^T + b_hh."""

    gates = 4

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        gates = (matmul(x, self.weight_ih, self.bf16) + self.bias_ih
                 + matmul(h, self.weight_hh, self.bf16) + self.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new


class GRUCell(_Cell):
    """Gates [r, z, n] with torch's composition n = tanh(i_n + r * h_n)."""

    gates = 3

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        gi = matmul(x, self.weight_ih, self.bf16) + self.bias_ih
        gh = matmul(h, self.weight_hh, self.bf16) + self.bias_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h, c
