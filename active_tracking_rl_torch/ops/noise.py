"""Random draws from one counter-based generator, the same on every device.

Every port function that uses randomness takes its draws as tensors; these
helpers make those draws in production. Tests feed the draws that
``jax.random`` made instead.

The generator is threefry2x32, ``jax.random``'s default, written in plain
integer ops (each uint32 word held in an int64 tensor, with masks and
shifts that are logical on non-negative values), so a draw gives the same
bits on the CPU and on the card. A ``Threefry`` is a key (two uint32
words) and a 64-bit counter: a draw of n values takes the next n counters
and hashes each, as ``jax.random.bits`` hashes the flat index of its
output under partitionable threefry (``bits1 ^ bits2`` of the counter's
high and low words); no counter is used twice. ``uniform`` and ``gumbel``
transform those bits as ``jax.random.uniform`` and ``jax.random.gumbel``
do, and ``split``/``fold_in`` derive keys as JAX's do; a fresh
``Threefry`` seeded with ``s`` draws what ``jax.random`` draws from
``jax.random.PRNGKey(s)``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

_TINY = torch.finfo(torch.float32).tiny
_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: counters hashed per pass (bounds the int64 temporaries)
_CHUNK = 1 << 24

Key = Tuple[int, int]


def threefry_2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of the counter words (x0, x1),
    int64 tensors holding uint32 values, under `key`; new tensors."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(_M32)
    x1 = (x1 + ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            low = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_or_(low).bitwise_and_(_M32)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def _hash_pairs(key: Key, words: Sequence[Tuple[int, int]]
                ) -> Tuple[Tuple[int, int], ...]:
    """threefry2x32 of a few (x0, x1) counter pairs, as Python ints."""
    x = torch.tensor(words, dtype=torch.int64).reshape(-1, 2)
    y0, y1 = threefry_2x32(key, x[:, 0].clone(), x[:, 1].clone())
    return tuple(zip(y0.tolist(), y1.tolist()))


def seed_key(seed: int) -> Key:
    """The raw key of an integer seed (``jax.random.PRNGKey``: the seed's
    high and low 32-bit words)."""
    seed = int(seed) & ((1 << 64) - 1)
    return (seed >> 32, seed & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in`` of a raw key and a 32-bit integer."""
    (a, b), = _hash_pairs(key, [(0, int(data) & _M32)])
    return (a, b)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split`` of a raw key (partitionable threefry)."""
    return _hash_pairs(key, [(0, i) for i in range(num)])


class Threefry:
    """A threefry2x32 key and counter: the port's generator.

    Carries the part of ``torch.Generator``'s surface the port uses:
    ``device`` (where its draws are made unless a caller names another;
    the bits do not depend on it), ``manual_seed``, ``get_state`` and
    ``set_state`` (an int64 CPU tensor: the key's two words and the
    counter)."""

    def __init__(self, device="cpu", key: Key = (0, 0), counter: int = 0):
        self.device = torch.device(device)
        self.key = (int(key[0]), int(key[1]))
        self.counter = int(counter)

    def manual_seed(self, seed: int) -> "Threefry":
        self.key, self.counter = seed_key(seed), 0
        return self

    def get_state(self) -> torch.Tensor:
        return torch.tensor([*self.key, self.counter], dtype=torch.int64)

    def set_state(self, state: torch.Tensor) -> "Threefry":
        k0, k1, counter = (int(v) for v in state.tolist())
        self.key, self.counter = (k0, k1), counter
        return self

    def fold_in(self, data: int) -> "Threefry":
        """A fresh generator on the same device, keyed by fold_in(key,
        data)."""
        return Threefry(self.device, fold_in(self.key, data))

    def take(self, n: int) -> int:
        """Reserve the next n counters; returns the first."""
        start = self.counter
        self.counter += n
        return start


def generator(seed: int, device="cpu") -> Threefry:
    """A Threefry seeded with `seed`."""
    return Threefry(device).manual_seed(seed)


def _device(generator: Threefry, device) -> torch.device:
    return generator.device if device is None else torch.device(device)


def _block_counters(shape: Tuple[int, ...], start: int, dim: int, lo: int,
                    hi: int, device) -> torch.Tensor:
    """The counters of block lo..hi-1 along `dim` of a draw of `shape` whose
    first counter is `start`, flat in the block's row-major order."""
    sub = list(shape)
    sub[dim] = hi - lo
    stride = [math.prod(shape[k + 1:]) for k in range(len(shape))]
    idx = torch.full((1,) * len(shape), start + lo * stride[dim],
                     dtype=torch.int64, device=device)
    for k, (m, st) in enumerate(zip(sub, stride)):
        view = [1] * len(shape)
        view[k] = m
        idx = idx + (torch.arange(m, dtype=torch.int64, device=device)
                     * st).view(view)
    return idx.reshape(-1)


def bits(shape, generator: Threefry, device=None,
         rows: Optional[Tuple[int, int]] = None, dim: int = 0
         ) -> torch.Tensor:
    """Uniform 32-bit words of `shape` (an int64 tensor of uint32 values),
    the next prod(shape) counters' hashes. With `rows` = (lo, hi): the
    block lo..hi-1 along `dim` of that draw, the generator advancing as for
    the whole draw (a data-parallel rank's block)."""
    shape = tuple(shape)
    dev = _device(generator, device)
    n = math.prod(shape)
    start = generator.take(n)
    if rows is not None and tuple(rows) == (0, shape[dim]):
        rows = None
    if rows is None:
        out_shape, counters = shape, None
    else:
        out_shape = shape[:dim] + (rows[1] - rows[0],) + shape[dim + 1:]
        counters = _block_counters(shape, start, dim, *rows, dev)
        n = counters.numel()
    out = torch.empty(n, dtype=torch.int64, device=dev)
    for c0 in range(0, n, _CHUNK):
        c1 = min(n, c0 + _CHUNK)
        c = (torch.arange(start + c0, start + c1, dtype=torch.int64,
                          device=dev) if counters is None
             else counters[c0:c1])
        y0, y1 = threefry_2x32(generator.key, c >> 32, c & _M32)
        out[c0:c1] = y0.bitwise_xor_(y1)
    return out.reshape(out_shape)


def uniform(shape, generator: Threefry, device=None, low: float = 0.0,
            high: float = 1.0, rows: Optional[Tuple[int, int]] = None,
            dim: int = 0) -> torch.Tensor:
    """float32 on [low, high), as ``jax.random.uniform``: the top 23 bits
    as a mantissa on [1, 2), less 1, scaled, then at least `low`. `rows`
    and `dim` as in `bits`."""
    w = bits(shape, generator, device, rows, dim)
    f = ((w >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if (low, high) == (0.0, 1.0):
        return f
    lo = torch.tensor(low, dtype=torch.float32)
    span = (torch.tensor(high, dtype=torch.float32) - lo).item()
    # f * span + lo as XLA's fused multiply-add computes it: the float64
    # product of two float32 values is exact, and the sum is rounded to
    # float32
    return torch.clamp_min((f.double() * span + lo.item()).float(),
                           lo.item())


def gumbel(shape, generator: Threefry, device=None,
           rows: Optional[Tuple[int, int]] = None, dim: int = 0
           ) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log U) with U on [tiny, 1), float32
    (``jax.random.gumbel``). `rows` and `dim` as in `bits`."""
    # uniform on [tiny, 1): in float32, f * (1 - tiny) + tiny is f for
    # every f >= 2^-23 and tiny for f = 0
    u = uniform(shape, generator, device, rows=rows, dim=dim)
    return -torch.log(-torch.log(u.clamp_min_(_TINY)))


def normal(shape, generator: Threefry, device=None) -> torch.Tensor:
    """Standard normal noise, sqrt(2) erfinv(U) with U on (-1, 1), float32
    (``jax.random.normal``)."""
    low = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(shape, generator, device, low, 1.0)
    return torch.erfinv(u) * math.sqrt(2.0)


def randint(high: int, shape, generator: Threefry, device=None,
            dtype=torch.int64, rows: Optional[Tuple[int, int]] = None
            ) -> torch.Tensor:
    """Uniform integers on [0, high): floor(high * w / 2^32) of a 32-bit
    word w (a bias below high / 2^32)."""
    w = bits(shape, generator, device, rows)
    return ((w * int(high)) >> 32).to(dtype)


def permutations(n_rows: int, n: int, generator: Threefry, device=None,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(n_rows, n) int64: one uniform permutation of range(n) per row, the
    stable sort of 32-bit integer keys (equal keys keep their order, so
    the card and the CPU agree)."""
    keys = bits((n_rows, n), generator, device, rows)
    return torch.argsort(keys, dim=-1, stable=True)
