"""threefry2x32 draws, frozen here so that the yardstick does not move with
the program.

The counter-based generator of ``jax.random`` (partitionable threefry): a
key of two uint32 words and a 64-bit counter; a draw of n values hashes the
next n counters (``bits1 ^ bits2`` of the hash of the counter's high and
low words), so the same seed gives the same bits on any device. Every
uint32 word is held in an int64 tensor.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def threefry_2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round threefry2x32 hash of the words (x0, x1) under `key`."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def seed_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words."""
    seed = int(seed) & ((1 << 64) - 1)
    return (seed >> 32, seed & _M32)


def fold_in(key, data: int) -> Tuple[int, int]:
    """``jax.random.fold_in``."""
    y0, y1 = threefry_2x32(key, torch.tensor([0]),
                           torch.tensor([int(data) & _M32]))
    return (int(y0), int(y1))


class Generator:
    """A key and the next unused counter."""

    def __init__(self, seed: Optional[int] = None, device="cpu",
                 key: Tuple[int, int] = (0, 0)):
        self.device = torch.device(device)
        self.key = seed_key(seed) if seed is not None else tuple(key)
        self.counter = 0

    def fold_in(self, data: int) -> "Generator":
        return Generator(None, self.device, fold_in(self.key, data))

    def take(self, n: int) -> int:
        start = self.counter
        self.counter += n
        return start


def bits(shape, gen: Generator) -> torch.Tensor:
    """uint32 words of `shape` in int64."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = gen.take(n) + torch.arange(n, dtype=torch.int64,
                                     device=gen.device)
    out = torch.empty_like(idx)
    step = 1 << 24
    for a in range(0, idx.numel(), step):
        c = idx[a:a + step]
        y0, y1 = threefry_2x32(gen.key, c >> 32, c & _M32)
        out[a:a + step] = y0 ^ y1
    return out.reshape(shape)


def uniform(shape, gen: Generator, low: float = 0.0, high: float = 1.0
            ) -> torch.Tensor:
    """float32 on [low, high) as ``jax.random.uniform``: 23 random mantissa
    bits on [1, 2), less 1, scaled by a float32 multiply-add."""
    w = bits(shape, gen)
    f = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if (low, high) == (0.0, 1.0):
        return f
    lo = float(torch.tensor(low, dtype=torch.float32))
    span = float(torch.tensor(high, dtype=torch.float32) - lo)
    return torch.clamp_min((f.double() * span + lo).float(), lo)


def gumbel(shape, gen: Generator) -> torch.Tensor:
    """-log(-log U), U on [tiny, 1), float32."""
    u = uniform(shape, gen).clamp_min(_TINY)
    return -torch.log(-torch.log(u))


def randint(high: int, shape, gen: Generator) -> torch.Tensor:
    """floor(high * w / 2^32) of a uint32 word w."""
    return (bits(shape, gen) * int(high)) >> 32


def permutations(n_rows: int, n: int, gen: Generator) -> torch.Tensor:
    """A permutation of range(n) per row: the stable sort of random words."""
    return torch.argsort(bits((n_rows, n), gen), dim=-1, stable=True)
