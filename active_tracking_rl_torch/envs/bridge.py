"""Host-side gym bridge: the classic gym API over the port's Track2D engine,
and the wrapper chain for external (non-Track2D) env families.

Port of ``active_tracking_rl_tpu/envs/bridge.py``:

  * :class:`GymTrackEnv`: one Track2D episode at a time, a batch-of-1
    :class:`~active_tracking_rl_torch.envs.env.TrackEnv` on its device, with
    the gym surface ``reset() -> obs``, ``step([a0, a1]) -> (obs, rewards,
    done, info)``, ``seed`` and ``render``. Every reset draws from the env's
    own generator (``seed`` seeds it); ``reset(draws)`` takes given draws.
  * the wrappers :class:`Rescale`, :class:`ImagePreprocess`,
    :class:`FrameStack` and :class:`ListSpace`, on host numpy arrays;
  * :func:`make_external_env`: external 3D families (``gym_unrealcv``)
    behind a lazy import, so Track2D-only installs never need them;
  * :func:`create_env`, the factory with the wrapper chain, and
    :class:`HostEnvPool`, which batches N host envs behind the (B, ...)
    array interface of ``rl/host_loop.py``.
"""

from __future__ import annotations

import collections
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from active_tracking_rl_torch.config import EnvConfig, parse_env_id
from active_tracking_rl_torch.envs.env import ResetDraws, TrackEnv
from active_tracking_rl_torch.ops import noise


class GymTrackEnv:
    """Classic gym-style host adapter over the Track2D engine.

    ``reset`` draws a new map (and spawns and tape); ``step`` returns
    per-agent obs ``(agents, 1, H, W)`` float32, rewards ``(agents,)``
    float32, done as a bool and the info dict (distance, eps_len,
    collision, traces, traces_relative), all on the host. ``resets`` counts
    the resets.
    """

    metadata = {"render.modes": ["human", "rgb_array", "ansi"]}

    def __init__(self, env_id: str, cfg: Optional[EnvConfig] = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg if cfg is not None else parse_env_id(env_id)
        self.env_id = env_id
        self._env = TrackEnv(self.cfg, device)
        self._generator = noise.generator(seed, self._env.device)
        self._state = None
        self._traces: List[np.ndarray] = []
        self.resets = 0
        h, w = self.cfg.obs_shape
        n = self.cfg.num_agents
        self.observation_space = _BoxSpace(
            low=0.0, high=6.0, shape=(n, 1, h, w))
        self.action_space = _DiscreteSpace(self.cfg.num_actions, n)

    def seed(self, seed: Optional[int] = None):
        """Seeds the generator of every later reset."""
        if seed is not None:
            self._generator.manual_seed(seed)
        return [seed]

    def reset(self, draws: Optional[ResetDraws] = None) -> np.ndarray:
        """A fresh episode from `draws` (one row), else from the env's
        generator."""
        if draws is None:
            draws = self._env.draw_reset(1, self._generator)
        self._state, obs = self._env.reset(draws)
        self.resets += 1
        obs, pos = obs[0].cpu().numpy(), self._state.pos[0].cpu().numpy()
        self._traces = [pos]
        # (agents, H, W) uint8 -> (agents, 1, H, W) float32
        return obs.astype(np.float32)[:, None]

    def step(self, actions: Sequence[int]):
        if self._state is None:
            raise RuntimeError("call reset() first")
        acts = torch.as_tensor(np.asarray(actions, np.int32).reshape(1, -1))
        self._state, obs, rewards, done, info = self._env.step(
            self._state, acts.to(self._env.device))
        obs, rewards, done, pos, dist, eps_len, coll = (
            t.cpu().numpy() for t in (
                obs[0], rewards[0], done[0], self._state.pos[0],
                info["distance"][0], info["eps_len"][0],
                info["collision"][0]))
        self._traces.append(pos)
        info_h = {
            "distance": float(dist),
            "eps_len": int(eps_len),
            "collision": coll,
            "traces": [list(t.astype(float)) for t in pos],
            "traces_relative": [
                list(((t - pos[0]).astype(float) / self.cfg.pob_size))
                for t in pos],
        }
        return obs.astype(np.float32)[:, None], rewards, bool(done), info_h

    def render(self, mode: str = "human"):
        from active_tracking_rl_torch.envs.render import render_state
        if self._state is None:
            raise RuntimeError("call reset() first")
        return render_state(self.cfg, self._state, traces=self._traces,
                            mode=mode)

    def close(self):
        pass


class _BoxSpace:
    """Minimal gym.spaces.Box stand-in (keeps gym optional)."""

    def __init__(self, low, high, shape, dtype=np.float32):
        self.low, self.high, self.shape, self.dtype = low, high, shape, dtype

    def sample(self):
        return np.random.uniform(self.low, self.high,
                                 self.shape).astype(self.dtype)


class _DiscreteSpace:
    """Per-agent discrete action space list (listspace convention)."""

    def __init__(self, n: int, num_agents: int = 1):
        self.n = n
        self.num_agents = num_agents
        self.shape = (num_agents,)

    def sample(self):
        return np.random.randint(0, self.n, self.num_agents)


# ---------------------------------------------------------------------------
# The wrapper chain, host-side.
# ---------------------------------------------------------------------------


class Wrapper:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self):
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)


class Rescale(Wrapper):
    """[0, 255] -> [-1, 1] linear map with clipping; optional random
    per-episode inversion (the ``--inv`` flag)."""

    def __init__(self, env, inv: bool = False):
        super().__init__(env)
        self.inv = inv
        self._sign = 1.0

    def _map(self, obs):
        obs = np.asarray(obs, np.float32)
        out = obs / 255.0 * 2.0 - 1.0
        return np.clip(out * self._sign, -1.0, 1.0)

    def reset(self):
        if self.inv:
            self._sign = 1.0 if np.random.rand() < 0.5 else -1.0
        return self._map(self.env.reset())

    def step(self, action):
        obs, r, d, info = self.env.step(action)
        return self._map(obs), r, d, info


class ImagePreprocess(Wrapper):
    """3D-image preprocessing: center-crop to square, resize to
    ``input_size``, optional grayscale (channel mean), HWC -> CHW."""

    def __init__(self, env, input_size: int = 80, gray: bool = False):
        super().__init__(env)
        self.input_size = input_size
        self.gray = gray

    def _one(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        img = img[y0:y0 + s, x0:x0 + s]
        img = _resize(img, self.input_size)
        if self.gray:
            img = img.mean(axis=-1, keepdims=True)
        return np.moveaxis(img, -1, 0)  # HWC -> CHW

    def _map(self, obs):
        return np.stack([self._one(np.asarray(o, np.float32)) for o in obs])

    def reset(self):
        return self._map(self.env.reset())

    def step(self, action):
        obs, r, d, info = self.env.step(action)
        return self._map(obs), r, d, info


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """cv2's resize where cv2 is installed, else a numpy bilinear resize."""
    try:
        import cv2
        return cv2.resize(img, (size, size))
    except ImportError:
        h, w = img.shape[:2]
        ys = np.clip((np.arange(size) + 0.5) * h / size - 0.5, 0, h - 1)
        xs = np.clip((np.arange(size) + 0.5) * w / size - 0.5, 0, w - 1)
        y0, x0 = ys.astype(int), xs.astype(int)
        y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        if img.ndim == 2:
            img = img[..., None]
        fy, fx = fy[..., None], fx[..., None]
        return (img[y0][:, x0] * (1 - fy) * (1 - fx)
                + img[y0][:, x1] * (1 - fy) * fx
                + img[y1][:, x0] * fy * (1 - fx)
                + img[y1][:, x1] * fy * fx)


class FrameStack(Wrapper):
    """Per-agent deque of the last k observations: ``reset`` fills all slots
    with copies; output stacks over a new axis after the agent axis ->
    per-agent shape (k, C, H, W)."""

    def __init__(self, env, stack_frames: int = 1):
        super().__init__(env)
        self.k = stack_frames
        self._q: List[collections.deque] = []

    def _out(self):
        return np.stack([np.stack(list(q)) for q in self._q])

    def reset(self):
        obs = self.env.reset()
        self._q = [collections.deque([np.asarray(o)] * self.k, maxlen=self.k)
                   for o in obs]
        return self._out()

    def step(self, action):
        obs, r, d, info = self.env.step(action)
        for q, o in zip(self._q, obs):
            q.append(np.asarray(o))
        if isinstance(d, (list, tuple)):
            d = all(d)  # a list of per-agent dones collapses to one
        return self._out(), r, d, info


class ListSpace(Wrapper):
    """A single-agent env in the list-of-agents convention: obs and reward
    gain a length-1 leading axis and actions are unwrapped from a 1-list."""

    def reset(self):
        return np.asarray(self.env.reset())[None]

    def step(self, action):
        obs, r, d, info = self.env.step(action[0])
        return np.asarray(obs)[None], np.asarray([r], np.float32), d, info


def make_external_env(env_id: str):
    """Lazy import boundary for non-Track2D env families (the UE4 3D envs of
    ``gym_unrealcv``): imported only when such an id is asked for."""
    import importlib
    if "Unreal" in env_id or "General" in env_id:
        try:
            importlib.import_module("gym_unrealcv")
        except ImportError as e:
            raise ImportError(
                f"env id {env_id!r} needs the external 'gym_unrealcv' "
                "package (UE4 binaries); install it separately — it is "
                "intentionally not a dependency of this framework.") from e
        import gym
        return gym.make(env_id)
    raise ValueError(f"unknown external env family for id {env_id!r}")


def create_env(env_id: str, rescale: bool = False, inv: bool = False,
               single: bool = False, stack_frames: int = 1,
               input_size: int = 80, gray: bool = False, seed: int = 0,
               device="cuda"):
    """The env factory and its wrapper chain: ``ListSpace`` if single ->
    ``Rescale`` if rescale -> image preprocessing for non-2D image envs ->
    ``FrameStack`` always. A Track2D id's env runs on `device`."""
    if "Track2D" in env_id:
        env: Any = GymTrackEnv(env_id, seed=seed, device=device)
        is_2d = True
    else:
        env = make_external_env(env_id)
        is_2d = False
    if single:
        env = ListSpace(env)
    if rescale:
        env = Rescale(env, inv=inv)
    if not is_2d:
        env = ImagePreprocess(env, input_size=input_size, gray=gray)
    return FrameStack(env, stack_frames)


class HostEnvPool:
    """N host gym envs behind the learner's (B, ...) array interface; a done
    env is reset at once. ``resets`` counts every reset it made."""

    def __init__(self, env_fns: Sequence[Any]):
        self.envs = [fn() for fn in env_fns]
        self.resets = 0

    def reset(self) -> np.ndarray:
        self.resets += len(self.envs)
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
        obs, rews, dones, infos = [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, d, i = e.step(a)
            if d:
                o = e.reset()
                self.resets += 1
            obs.append(o)
            rews.append(r)
            dones.append(d)
            infos.append(i)
        return (np.stack(obs), np.stack(rews),
                np.asarray(dones, bool), infos)

    def __len__(self):
        return len(self.envs)
