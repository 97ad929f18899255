"""Weight initializers: the reference's effective init, from a generator.

Every Conv/Linear weight is U(-b, b) with b = sqrt(6 / (fan_in + fan_out))
(for a conv, fan_in = in * kh * kw and fan_out = kh * kw * out) and bias 0.
LSTM weights keep torch's default U(-1/sqrt(H), 1/sqrt(H)), biases 0.
Port of ``active_tracking_rl_tpu/models/init.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from active_tracking_rl_torch.ops import noise


def _uniform_(weight: torch.Tensor, b: float,
              generator: noise.Threefry) -> torch.Tensor:
    """weight <- U(-b, b) drawn by `generator`."""
    with torch.no_grad():
        return weight.copy_(noise.uniform(tuple(weight.shape), generator,
                                          weight.device, -b, b))


def ref_uniform_(weight: torch.Tensor, fan_in: int, fan_out: int,
                 generator: noise.Threefry) -> torch.Tensor:
    b = math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform_(weight, b, generator)


def init_conv_(conv: nn.Conv2d, generator: noise.Threefry) -> None:
    """Conv2d weight (out, in, kh, kw) <- reference uniform; bias 0."""
    cout, cin, kh, kw = conv.weight.shape
    ref_uniform_(conv.weight, cin * kh * kw, kh * kw * cout, generator)
    nn.init.zeros_(conv.bias)


def init_linear_(lin: nn.Linear, generator: noise.Threefry) -> None:
    """Linear weight (out, in) <- reference uniform; bias 0."""
    fan_out, fan_in = lin.weight.shape
    ref_uniform_(lin.weight, fan_in, fan_out, generator)
    nn.init.zeros_(lin.bias)


def torch_rnn_uniform_(weight: torch.Tensor, hidden_size: int,
                       generator: noise.Threefry) -> torch.Tensor:
    """torch's LSTMCell default U(-1/sqrt(H), 1/sqrt(H))."""
    return _uniform_(weight, 1.0 / math.sqrt(hidden_size), generator)
