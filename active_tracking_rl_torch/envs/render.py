"""Episode rendering, on the host with numpy.

The port's copy of ``active_tracking_rl_tpu/envs/render.py``. A pure
function of (config, a one-row EnvState, traces):

  * ``mode="rgb_array"`` -> (S, S, 3) uint8 image (free white, wall black,
    tracker blue, target red, traces tinted),
  * ``mode="ansi"``      -> a unicode text grid (terminal debugging),
  * ``mode="human"``     -> matplotlib imshow if it is installed, else
    prints the text grid.

matplotlib and PIL are imported only where they are used (``human`` mode and
``save_episode_gif``): neither is a dependency of the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from active_tracking_rl_torch.config import EnvConfig
from active_tracking_rl_torch.envs.types import EnvState

#: cell palette: value -> RGB of the painted maze values 0..6.
_PALETTE = {
    0: (255, 255, 255),   # free
    1: (40, 40, 40),      # wall
    2: (50, 90, 255),     # tracker
    3: (120, 200, 255),   # tracker trace
    4: (255, 60, 60),     # target
    5: (255, 170, 170),   # target trace
    6: (180, 120, 255),   # extra agents
}

_GLYPH = {0: "·", 1: "█", 2: "T", 3: "t", 4: "X", 5: "x", 6: "?"}


def _painted_grid(cfg: EnvConfig, state: EnvState,
                  traces: Optional[Sequence[np.ndarray]] = None
                  ) -> np.ndarray:
    """The maze of the state's one row with agents (2+2i) and traces (3+2i)
    painted, a uint8 grid; `traces` are (agents, 2) positions, the last one
    current."""
    p = cfg.pob_size
    s = cfg.maze_size
    maze = state.maze[0].cpu().numpy()[p:p + s, p:p + s].copy()
    if traces:
        for snap in traces[:-1]:
            for i, (r, c) in enumerate(np.asarray(snap)):
                if maze[r, c] == 0:
                    maze[r, c] = 3 + 2 * min(i, 1)
    for i, (r, c) in enumerate(state.pos[0].cpu().numpy()):
        maze[r, c] = 2 + 2 * min(i, 2)
    return maze


def to_rgb(grid: np.ndarray) -> np.ndarray:
    img = np.zeros(grid.shape + (3,), np.uint8)
    for v, rgb in _PALETTE.items():
        img[grid == v] = rgb
    return img


def to_ansi(grid: np.ndarray) -> str:
    return "\n".join("".join(_GLYPH.get(int(v), "?") for v in row)
                     for row in grid)


def render_state(cfg: EnvConfig, state: EnvState,
                 traces: Optional[Sequence[np.ndarray]] = None,
                 mode: str = "rgb_array"):
    grid = _painted_grid(cfg, state, traces)
    if mode == "ansi":
        return to_ansi(grid)
    img = to_rgb(grid)
    if mode == "rgb_array":
        return img
    if mode == "human":
        try:
            import matplotlib.pyplot as plt
            plt.imshow(img)
            plt.axis("off")
            plt.pause(0.01)
        except ImportError:
            print(to_ansi(grid))
        return None
    raise ValueError(f"unknown render mode {mode!r}")


def save_episode_gif(frames: List[np.ndarray], path: str,
                     duration_ms: int = 60) -> None:
    """Save an episode of rgb_array frames as a GIF (needs PIL)."""
    from PIL import Image
    imgs = [Image.fromarray(f).resize((f.shape[1] * 4, f.shape[0] * 4),
                                      Image.NEAREST) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=duration_ms, loop=0)
