"""Two-sample KS and chi-square tests at alpha ~1e-3, and category
counts: copies of tests/test_distributions.py's helpers in a module that
imports no JAX, so the card's tests (tests/test_torch_cuda.py) use them
too."""

from __future__ import annotations

import numpy as np

# chi-square critical values at alpha = 0.001
_CHI2_CRIT = {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47, 5: 20.52,
              6: 22.46, 7: 24.32, 8: 26.12, 9: 27.88, 10: 29.59}

#: the target's spawn offsets from the tracker: the 3 x 3 window's cells
OFFSET_CATS = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)]


def ks_2samp_ok(a, b, alpha_c: float = 1.95) -> "tuple[bool, float, float]":
    """Two-sample KS test; alpha_c=1.95 ~ alpha=0.001."""
    a, b = np.sort(np.asarray(a)), np.sort(np.asarray(b))
    n, m = len(a), len(b)
    allv = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, allv, side="right") / n
    cdf_b = np.searchsorted(b, allv, side="right") / m
    d = np.abs(cdf_a - cdf_b).max()
    crit = alpha_c * np.sqrt((n + m) / (n * m))
    return d <= crit, float(d), float(crit)


def chi2_2samp_ok(counts_a, counts_b) -> "tuple[bool, float, float]":
    """Two-sample chi-square homogeneity over shared categories."""
    ca = np.asarray(counts_a, np.float64)
    cb = np.asarray(counts_b, np.float64)
    keep = (ca + cb) > 0
    ca, cb = ca[keep], cb[keep]
    na, nb = ca.sum(), cb.sum()
    pooled = (ca + cb) / (na + nb)
    ea, eb = pooled * na, pooled * nb
    stat = float((((ca - ea) ** 2) / ea).sum() + (((cb - eb) ** 2) / eb).sum())
    dof = len(ca) - 1
    crit = _CHI2_CRIT.get(dof, 10.83 + 2.5 * dof)
    return stat <= crit, stat, crit


def counts(items, cats):
    """(counts of each of `cats` among `items`, count of the others)."""
    c = {k: 0 for k in cats}
    other = 0
    for it in items:
        if it in c:
            c[it] += 1
        else:
            other += 1
    return np.array([c[k] for k in cats]), other
