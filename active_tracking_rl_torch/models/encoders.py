"""Perception encoders, batched. Port of ``active_tracking_rl_tpu/models/encoders.py``.

Input (B, k, H, W, 1) float (the JAX package's layout, k the frame stack)
-> features (B, outdim) float32. The k frames are convolved as a batch and
their features flattened into one vector (the fc input, where there is an
fc). Inside, convolutions run NCHW; the conv output is put back to NHWC
before the flatten, so the features are in the JAX package's (k, H', W', C)
order and a flax Dense kernel converts by a transpose alone.

With ``bf16`` the encoder computes in bfloat16, as flax's ``dtype`` does:
each conv and the fc take bfloat16 inputs, weights and biases, their bias
adds, pools and relus stay in bfloat16, and only the features go back to
float32. An input too small for the conv stack (CNNSimple on a 13 x 13
partial window) gives empty features (B, 0), as the JAX module does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from active_tracking_rl_torch.models.init import init_conv_, init_linear_
from active_tracking_rl_torch.ops.noise import Threefry


def _conv_out(n: int, kernel: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - kernel) // stride + 1


def _conv(conv: nn.Conv2d, x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The conv, or under `bf16` its bfloat16 output plus the bfloat16 bias:
    two roundings, as flax's bf16 conv (the bias is not fused into it)."""
    if not bf16:
        return conv(x)
    b16 = torch.bfloat16
    y = F.conv2d(x.to(b16), conv.weight.to(b16), None, conv.stride,
                 conv.padding)
    return y + conv.bias.to(b16)[:, None, None]


def _fc(fc: nn.Linear, x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The fc, or under `bf16` its bfloat16 product plus the bfloat16 bias."""
    if not bf16:
        return fc(x)
    b16 = torch.bfloat16
    return x.to(b16) @ fc.weight.to(b16).t() + fc.bias.to(b16)


class _StackedConvEncoder(nn.Module):
    """Convs ``conv0..`` (each + relu, and a floor 2 x 2 max-pool first where
    ``pool``), flatten k frames' features, then an fc + relu unless
    ``fc_out`` is None."""

    #: (out channels, kernel, stride, padding) of each conv
    convs: Tuple[Tuple[int, int, int, int], ...] = ()
    pool = False
    fc_out: Optional[int] = 256

    def __init__(self, obs_hw: Tuple[int, int], stack_frames: int = 1,
                 bf16: bool = False):
        super().__init__()
        self.bf16 = bf16
        h, w = obs_hw
        chans = 1
        for i, (cout, kernel, stride, padding) in enumerate(self.convs):
            setattr(self, f"conv{i}", nn.Conv2d(chans, cout, kernel,
                                                stride=stride, padding=padding))
            chans = cout
            h, w = (_conv_out(n, kernel, stride, padding) for n in (h, w))
            if self.pool:
                h, w = h // 2, w // 2
            h, w = (max(n, 0) for n in (h, w))   # empty stays empty
        #: the input leaves no cell after the conv stack
        self.empty = h * w == 0
        feat = stack_frames * h * w * chans
        if self.fc_out is None:
            self.fc = None
            self.out_dim = feat
        else:
            self.fc = nn.Linear(feat, self.fc_out)
            self.out_dim = self.fc_out

    def reset_parameters(self, generator: Threefry) -> None:
        for i in range(len(self.convs)):
            init_conv_(getattr(self, f"conv{i}"), generator)
        if self.fc is not None:
            init_linear_(self.fc, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, k = x.shape[:2]
        if self.empty:
            x = x.new_zeros((b, 0), dtype=torch.float32)
        else:
            x = x.reshape((b * k,) + x.shape[2:]).permute(0, 3, 1, 2)
            for i in range(len(self.convs)):
                x = _conv(getattr(self, f"conv{i}"), x, self.bf16)
                if self.pool:
                    x = F.max_pool2d(x, 2)
                x = torch.relu(x)
            x = x.permute(0, 2, 3, 1).reshape(b, -1)
        if self.fc is not None:
            x = torch.relu(_fc(self.fc, x, self.bf16))
        return x.to(torch.float32)


class CNNMaze(_StackedConvEncoder):
    """conv(16,3,s2,p1) relu, conv(32,3,s2,p1) relu, fc 256 relu."""

    convs = ((16, 3, 2, 1), (32, 3, 2, 1))


class ICML(_StackedConvEncoder):
    """conv(16,8,s4,p2) relu, conv(32,4,s2,p1) relu, fc 256 relu."""

    convs = ((16, 8, 4, 2), (32, 4, 2, 1))


class CNNSimple(_StackedConvEncoder):
    """4 x [conv, floor max-pool 2, relu], no fc."""

    convs = ((32, 5, 1, 2), (32, 5, 1, 1), (64, 4, 1, 1), (64, 3, 1, 1))
    pool = True
    fc_out = None


ENCODERS = {"maze": CNNMaze, "icml": ICML, "cnn": CNNSimple}

#: each encoder's flax module name
FLAX_NAMES = {"maze": "CNNMaze_0", "icml": "ICML_0", "cnn": "CNNSimple_0"}


def make_encoder(name: str, obs_hw: Tuple[int, int], stack_frames: int = 1,
                 bf16: bool = False) -> _StackedConvEncoder:
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}")
    return ENCODERS[name](obs_hw, stack_frames, bf16)
