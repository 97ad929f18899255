"""LSTM cell with torch's gate semantics, written out.

Port of ``active_tracking_rl_tpu/models/recurrent.py:LSTMCell``. The
parameters have ``nn.LSTMCell``'s names and shapes; the arithmetic is the
JAX module's, in its order. GRUCell waits.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from active_tracking_rl_torch.models.init import torch_rnn_uniform_


class LSTMCell(nn.Module):
    """Gates [i, f, g, o] from x W_ih^T + b_ih + h W_hh^T + b_hh."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.zeros(4 * hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_rnn_uniform_(self.weight_ih, self.hidden, generator)
        torch_rnn_uniform_(self.weight_hh, self.hidden, generator)
        nn.init.zeros_(self.bias_ih)
        nn.init.zeros_(self.bias_hh)

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        gates = (x @ self.weight_ih.t() + self.bias_ih
                 + h @ self.weight_hh.t() + self.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new
