"""Perception encoders, batched. Port of ``active_tracking_rl_tpu/models/encoders.py``.

Input (B, k, H, W, 1) float (the JAX package's layout, k the frame stack)
-> features (B, outdim). The k frames are convolved as a batch and their
features flattened into one fc input. Inside, convolutions run NCHW; the
conv output is put back to NHWC before the flatten, so the fc weight's
columns are in the JAX package's (k, H', W', C) order and a flax Dense
kernel converts by a transpose alone. Only CNNMaze is ported; ICML and
CNNSimple wait.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from active_tracking_rl_torch.models.init import init_conv_, init_linear_


def _conv_out(n: int, kernel: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - kernel) // stride + 1


class CNNMaze(nn.Module):
    """conv(16,3,s2,p1) relu, conv(32,3,s2,p1) relu, fc 256 relu."""

    def __init__(self, obs_hw: Tuple[int, int], stack_frames: int = 1,
                 fc_out: int = 256):
        super().__init__()
        self.conv0 = nn.Conv2d(1, 16, 3, stride=2, padding=1)
        self.conv1 = nn.Conv2d(16, 32, 3, stride=2, padding=1)
        h, w = (_conv_out(_conv_out(n, 3, 2, 1), 3, 2, 1) for n in obs_hw)
        self.fc = nn.Linear(stack_frames * h * w * 32, fc_out)
        self.out_dim = fc_out

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_conv_(self.conv0, generator)
        init_conv_(self.conv1, generator)
        init_linear_(self.fc, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, k = x.shape[:2]
        x = x.reshape((b * k,) + x.shape[2:]).permute(0, 3, 1, 2)
        x = torch.relu(self.conv0(x))
        x = torch.relu(self.conv1(x))
        x = x.permute(0, 2, 3, 1).reshape(b, -1)
        return torch.relu(self.fc(x))
