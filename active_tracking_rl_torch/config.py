"""Typed configuration: the port's own copy of the JAX package's config.

Same env-id grammar (72 ids), same field names and defaults as
``active_tracking_rl_tpu/config.py``. ``flood_backend`` keeps the JAX names; each picks a flood
implementation, and the tensor's device picks the kernel or its plain twin
(``envs/distance.py:distance_fields_backend``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

MAP_TYPES = ("Maze", "Block", "Empty")
OBS_TYPES = ("Full", "Partial")
TARGET_MODES = ("Adv", "PZR", "Far", "Nav", "Ram", "RPF")
LEVELS = (0, 1)

#: target modes whose action the env overrides with a scripted tape.
SCRIPTED_MODES = ("Nav", "Ram", "RPF")


def env_ids() -> Tuple[str, ...]:
    """All 72 registered env ids."""
    return tuple(f"Track2D-{m}{o}{t}-v{lvl}" for m, o, t, lvl in
                 itertools.product(MAP_TYPES, OBS_TYPES, TARGET_MODES, LEVELS))


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration."""

    map_type: str = "Block"          # Maze | Block | Empty
    obs_type: str = "Partial"        # Full | Partial
    target_mode: str = "PZR"         # Adv | PZR | Far | Nav | Ram | RPF
    level: int = 0
    pob_size: int = 6                # partial window half-size
    action_type: str = "VonNeumann"  # VonNeumann (4) | Moore (8)
    num_agents: int = 2
    max_episode_steps: int = 500
    #: scripted-target action-tape length (>= max_episode_steps + 1).
    tape_len: int = 512
    #: pre-sampled navigator goal candidates per episode.
    nav_goal_candidates: int = 16
    #: flood-fill cap: paths longer than this count as unreachable.
    flood_iters: int = 256
    #: distance-field backend: "auto" or "pallas_sweep" (the fast-sweep
    #: kernel), "pallas" (the relaxation kernel), "xla" (the plain
    #: relaxation) or "sweep" (the plain fast sweep).
    flood_backend: str = "auto"
    #: training aid for Full-obs configs: roll each agent's full map so the
    #: observer sits at the centre cell (off for every registered id).
    center_full_obs: bool = False

    @property
    def maze_size(self) -> int:
        """81 for Maze (odd grid), 82 for Block/Empty (80 + wall pad)."""
        if self.map_type == "Maze":
            return ((80 // 2) * 2) + 1
        return 80 + 2

    @property
    def num_actions(self) -> int:
        return 4 if self.action_type == "VonNeumann" else 8

    @property
    def pob_window(self) -> int:
        return 2 * self.pob_size + 1

    @property
    def scripted(self) -> bool:
        return self.target_mode in SCRIPTED_MODES

    @property
    def w_p(self) -> float:
        """Partial-zero-sum penalty weight."""
        if self.target_mode == "PZR":
            return 1.0
        if self.target_mode == "Far":
            return -0.5
        return 0.0

    @property
    def obs_shape(self) -> Tuple[int, int]:
        if self.obs_type == "Full":
            return (self.maze_size, self.maze_size)
        return (self.pob_window, self.pob_window)


def parse_env_id(env_id: str) -> EnvConfig:
    """``Track2D-{Map}{Obs}{Target}-v{level}`` -> EnvConfig."""
    if not env_id.startswith("Track2D-"):
        raise ValueError(f"not a Track2D env id: {env_id!r}")
    body, _, ver = env_id[len("Track2D-"):].partition("-v")
    level = int(ver)
    for m in MAP_TYPES:
        if body.startswith(m):
            rest = body[len(m):]
            for o in OBS_TYPES:
                if rest.startswith(o):
                    target = rest[len(o):]
                    if target in TARGET_MODES and level in LEVELS:
                        return EnvConfig(map_type=m, obs_type=o,
                                         target_mode=target, level=level)
    raise ValueError(f"unknown env id: {env_id!r}")


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Network architecture, named ``{tat-}?{cnn|icml|maze}-{lstm|gru}``."""

    encoder: str = "maze"       # cnn | icml | maze
    rnn: str = "lstm"           # lstm | gru | none
    tat: bool = True            # tracker-aware target
    continuous: bool = False
    rnn_out: int = 128
    stack_frames: int = 1
    aux_reward: bool = True
    #: the encoder in bfloat16 (features cast back to float32) and the
    #: cell's matmuls on bfloat16 inputs; parameters, heads and the
    #: recurrent state stay float32.
    bf16: bool = False

    @classmethod
    def from_name(cls, name: str, rnn_out: int = 128, stack_frames: int = 1,
                  aux: str = "reward") -> "NetConfig":
        enc = "maze" if "maze" in name else ("icml" if "icml" in name else "cnn")
        rnn = "lstm" if "lstm" in name else ("gru" if "gru" in name else "none")
        return cls(encoder=enc, rnn=rnn, tat="tat" in name,
                   continuous="continuous" in name, rnn_out=rnn_out,
                   stack_frames=stack_frames, aux_reward="reward" in aux)

    @property
    def name(self) -> str:
        parts = ["tat"] if self.tat else []
        parts.append(self.encoder)
        if self.rnn != "none":
            parts.append(self.rnn)
        if self.continuous:
            parts.append("continuous")
        return "-".join(parts)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (same defaults as the JAX package)."""

    env_id: str = "Track2D-BlockPartialPZR-v0"
    env_base: str = "Track2D-BlockPartialNav-v0"
    lr: float = 1e-3
    gamma: float = 0.9
    tau: float = 1.0
    entropy: float = 0.01            # tracker entropy weight
    entropy_target: float = 0.2      # target entropy weight
    seed: int = 1
    num_steps: int = 20              # rollout length T
    max_step: int = 150_000
    test_eps: int = 100
    optimizer: str = "Adam"
    amsgrad: bool = True
    train_mode: int = -1             # 0 tracker, 1 target, -1 joint, 2 alternating
    init_step: int = -1
    adv_step: int = 500
    grad_clip: float = 50.0
    split: bool = True
    num_envs: int = 1024             # vectorized env batch
    reset_pool: int = 256            # fresh episodes generated per iteration
    log_dir: str = "logs"
    checkpoint_every: int = 200
    #: bfloat16 model inputs; the trainer CLI builds its NetConfig with
    #: this value (run/train.py:net_config_from_args).
    bf16: bool = False
    #: rematerialize each rollout step's model forward: the backward pass
    #: recomputes it from the uint8 frame stack, h, c and the step's noise
    #: instead of keeping its activations. A pure recomputation with
    #: bit-identical gradients. Off by default, as in the JAX dataclass;
    #: the trainer CLI turns it on (`--no-remat` turns it off), as the JAX
    #: CLI does.
    remat: bool = False


#: the JAX package's presets (the reference README's runs), field for field.
PRESETS = {
    # AD-VAT 2D: tat target + PZR reward, joint training
    "advat-2d": TrainConfig(env_id="Track2D-BlockPartialPZR-v0",
                            env_base="Track2D-BlockPartialNav-v0",
                            train_mode=-1),
    # naive dueling: plain A3C target, Adv reward, low target entropy
    "naive-dueling-2d": TrainConfig(env_id="Track2D-BlockPartialAdv-v0",
                                    env_base="Track2D-BlockPartialNav-v0",
                                    entropy_target=0.01, train_mode=-1),
    # tracker-only baselines vs scripted targets
    "tracker-nav-2d": TrainConfig(env_id="Track2D-BlockPartialNav-v0",
                                  train_mode=0),
    "tracker-ram-2d": TrainConfig(env_id="Track2D-BlockPartialRam-v0",
                                  env_base="Track2D-BlockPartialRam-v0",
                                  train_mode=0),
}


def preset(name: str) -> TrainConfig:
    return PRESETS[name]


def net_config_for(train_cfg: TrainConfig,
                   network: Optional[str] = None) -> NetConfig:
    """tat-maze-lstm for dueling PZR/Far, maze-lstm otherwise."""
    if network is not None:
        return NetConfig.from_name(network)
    cfg = parse_env_id(train_cfg.env_id)
    if cfg.target_mode in ("PZR", "Far") and train_cfg.train_mode != 0:
        return NetConfig.from_name("tat-maze-lstm")
    return NetConfig.from_name("maze-lstm", aux="none")
