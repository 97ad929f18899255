"""active_tracking_rl_torch — the PyTorch/CUDA port of active_tracking_rl_tpu.

The package mirrors the JAX package's layout (``envs/ models/ ops/ rl/ run/
utils/``): each module's reference is the JAX module of the same name. It
imports torch and numpy only. Entry points take an explicit ``device``
(default ``"cuda"``; the CLIs in ``run/`` take ``--device``); every
function that uses randomness takes its draws as tensors at a seam,
produced in production by ``ops/noise.py``'s counter-based threefry2x32
generator (``Threefry``, ``jax.random``'s algorithm in plain integer ops):
one seed gives the same draws on the CPU and on the card.

The hand-written kernel is the BFS flood fill, bound in ``ops/flood.py``:
one bit-parallel frontier BFS (``csrc/flood_bfs.cu``) behind the launchers
of the sweep, sweep16 and relax variants.
"""

__version__ = "0.1.0"

from active_tracking_rl_torch.config import (  # noqa: F401
    EnvConfig,
    NetConfig,
    TrainConfig,
    env_ids,
    parse_env_id,
)
