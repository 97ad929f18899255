"""Random draws from an explicit ``torch.Generator``.

Every port function that uses randomness takes its draws as tensors; these
helpers make those draws in production. Tests feed the draws that
``jax.random`` made instead.
"""

from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log U) with U on [tiny, 1), float32."""
    u = torch.rand(shape, generator=generator, device=device).clamp_min_(_TINY)
    return -torch.log(-torch.log(u))


def randint(high: int, shape, generator: torch.Generator, device,
            dtype=torch.int64) -> torch.Tensor:
    """Uniform integers on [0, high)."""
    return torch.randint(0, high, shape, generator=generator, device=device,
                         dtype=dtype)


def permutations(n_rows: int, n: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """(n_rows, n) int64: one uniform permutation of range(n) per row."""
    keys = torch.rand((n_rows, n), generator=generator, device=device)
    return torch.argsort(keys, dim=-1)
