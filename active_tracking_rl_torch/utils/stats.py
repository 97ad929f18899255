"""Statistics helpers for evaluation reports.

The port's copy of ``active_tracking_rl_tpu/utils/stats.py``.
"""

from __future__ import annotations

import math
from typing import List


def wilson_ci(successes: int, n: int, z: float = 1.96) -> List[float]:
    """Wilson score interval for a binomial proportion (default 95%),
    rounded to 4 places.

    It behaves at p near 0 or 1 and at small n, where the normal
    approximation degenerates: S_rate 1.00 on 300 episodes gives
    [0.9874, 1.0], not [1.0, 1.0].
    """
    if n == 0:
        return [0.0, 1.0]
    phat = successes / n
    denom = 1 + z * z / n
    center = (phat + z * z / (2 * n)) / denom
    half = z * math.sqrt(phat * (1 - phat) / n + z * z / (4 * n * n)) / denom
    return [round(center - half, 4), round(center + half, 4)]
