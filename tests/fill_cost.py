"""``python -m active_tracking_rl_torch.run.bench`` (same flags, same JSON
line) with ``torch.utils.deterministic.fill_uninitialized_memory`` on:
the deterministic mode as torch sets it by default, where every
``torch.empty`` and every allocation an op makes through it is filled
before use. Beside a plain ``run.bench`` in one call, its env-steps/s
give what the fill costs (``utils/platform.py:pin_deterministic`` leaves
it off). Run it from the root of the repository:

    python3 tests/fill_cost.py [run.bench flags]
"""

import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from active_tracking_rl_torch.run import bench  # noqa: E402


def pin_with_fill():
    settings = pin_deterministic()
    torch.utils.deterministic.fill_uninitialized_memory = True
    return dict(settings, fill_uninitialized_memory=True)


pin_deterministic = bench.pin_deterministic

if __name__ == "__main__":
    bench.pin_deterministic = pin_with_fill
    bench.main(sys.argv[1:])
