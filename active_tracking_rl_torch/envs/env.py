"""The Track2D engine: reset, step and the auto-reset pool, batched over rows.

Port of ``active_tracking_rl_tpu/envs/env.py``. ``reset`` and ``step`` work
on N rows at once (the JAX functions are single-row and vmapped). ``reset``
takes all its randomness as ``ResetDraws``; ``TrackEnv.draw_reset`` makes
them from a ``noise.Threefry`` on the env's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from active_tracking_rl_torch.config import EnvConfig, parse_env_id
from active_tracking_rl_torch.envs import maps
from active_tracking_rl_torch.envs.observe import observe
from active_tracking_rl_torch.envs.opponents import (NavDraws, RamDraws,
                                                     build_tape, deltas,
                                                     draw_nav, draw_ram)
from active_tracking_rl_torch.envs.types import EnvState, info_dict
from active_tracking_rl_torch.ops.noise import Threefry


@dataclasses.dataclass
class ResetDraws:
    map: maps.MapDraws
    spawns: maps.SpawnDraws
    nav: Optional[NavDraws] = None    # Nav and RPF only
    ram: Optional[RamDraws] = None    # Ram only


def draw_reset(cfg: EnvConfig, n: int, generator: Threefry, device,
               rows: Optional[Tuple[int, int]] = None) -> ResetDraws:
    """Every draw `reset` needs for n rows of `cfg`'s map and target mode;
    with `rows` = (lo, hi) only rows lo..hi-1 of them, the generator
    advancing as for n (a data-parallel rank's block)."""
    draws = ResetDraws(maps.draw_map(cfg, n, generator, device, rows),
                       maps.draw_spawns(cfg, n, generator, device, rows))
    if cfg.target_mode in ("Nav", "RPF"):
        draws.nav = draw_nav(cfg, n, generator, device, rows)
    elif cfg.target_mode == "Ram":
        draws.ram = draw_ram(cfg, n, generator, device, rows)
    return draws


@functools.lru_cache(maxsize=None)
def _reward_constants(max_d: float, w_p: float, device: torch.device):
    """1, -2/pob and -w_p/pob as float32 scalars on `device`."""
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in (1.0, -2.0 / max_d, -w_p / max_d))


def _distance(pos: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((pos[:, 1] - pos[:, 0]).to(torch.float32) ** 2).sum(-1))


def reset(cfg: EnvConfig, draws: ResetDraws) -> Tuple[EnvState, torch.Tensor]:
    """Fresh episodes: new map, spawns and scripted tape per row."""
    maze = maps.generate_map(cfg, draws.map)
    patrol = None
    if cfg.target_mode == "RPF":
        patrol = maps.patrol_goals(cfg, maze.device)
        maze = maps.carve_patrol(maze, patrol)
    pos, goals = maps.sample_spawns(cfg, maze, draws.spawns, patrol)
    tape = build_tape(cfg, maze, pos[:, 1], goals[:, 1], draws.nav,
                      draws.ram)
    p = cfg.pob_size
    maze_padded = torch.nn.functional.pad(maze, (p, p, p, p), value=1)
    n, dev = maze.shape[0], maze.device
    zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
    state = EnvState(
        maze=maze_padded,
        pos=pos,
        tape=tape,
        t=zeros,
        c_far=zeros.clone(),
        done=torch.zeros((n,), dtype=torch.bool, device=dev),
        c_reward=torch.zeros((n, cfg.num_agents), dtype=torch.float32,
                             device=dev),
        c_collision=torch.zeros((n, cfg.num_agents), dtype=torch.int32,
                                device=dev),
        dist=_distance(pos),
    )
    return state, observe(cfg, maze_padded, pos)


def step(cfg: EnvConfig, state: EnvState, actions: torch.Tensor):
    """One transition for every row, time limit included.

    actions: (N, 2) int. Scripted modes replace the target's action with
    ``tape[t]``. Returns (state', obs (N,2,H,W) uint8, rewards (N,2) float32,
    done (N,) bool, info).
    """
    p = cfg.pob_size
    n = state.num_rows
    rows = torch.arange(n, device=state.pos.device)
    acts = actions.long()
    if cfg.scripted:
        t = state.t.long().clamp_max(state.tape.shape[1] - 1)
        acts = torch.stack([acts[:, 0], state.tape[rows, t].long()], dim=1)

    # move; a wall cell means stay and count a collision
    nxt = state.pos + deltas(state.pos.device)[acts]
    cell = state.maze[rows[:, None], nxt[..., 0].long() + p,
                      nxt[..., 1].long() + p]
    hit = cell == 1
    pos = torch.where(hit[..., None], state.pos, nxt)

    # r0 = max(1 - 2d/pob, -1); r1 = max(-r0 - w_p * max(d - pob, 0)/pob, -1).
    # Each is one multiply-add with the constant folded to float32, the
    # rounding of the JAX package's compiled step (its golden traces hold
    # these bits).
    d = _distance(pos)
    max_d = float(p)
    one, c0, c1 = _reward_constants(max_d, cfg.w_p, d.device)
    r0 = torch.clamp_min(torch.addcmul(one, d, c0), -1.0)
    r1 = torch.clamp_min(
        torch.addcmul(-r0, torch.clamp_min(d - max_d, 0.0), c1), -1.0)
    rewards = torch.stack([r0, r1], dim=1)

    # lost for 11 consecutive steps, or the time limit
    c_far = torch.where(d <= max_d, 0, state.c_far + 1).to(torch.int32)
    t = state.t + 1
    done = (c_far > 10) | (t >= cfg.max_episode_steps)

    new_state = EnvState(
        maze=state.maze,
        pos=pos,
        tape=state.tape,
        t=t,
        c_far=c_far,
        done=done,
        c_reward=state.c_reward + rewards,
        c_collision=state.c_collision + hit.to(torch.int32),
        dist=d,
    )
    obs = observe(cfg, new_state.maze, new_state.pos)
    return new_state, obs, rewards, done, info_dict(new_state)


class TrackEnv:
    """Env bound to one EnvConfig and one device."""

    def __init__(self, cfg: EnvConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def draw_reset(self, n: int, generator: Threefry,
                   rows: Optional[Tuple[int, int]] = None) -> ResetDraws:
        return draw_reset(self.cfg, n, generator, self.device, rows)

    def reset(self, draws: ResetDraws) -> Tuple[EnvState, torch.Tensor]:
        return reset(self.cfg, draws)

    def step(self, state: EnvState, actions: torch.Tensor):
        return step(self.cfg, state, actions)

    def reset_batch(self, n: int, generator: Threefry,
                    rows: Optional[Tuple[int, int]] = None
                    ) -> Tuple[EnvState, torch.Tensor]:
        """n fresh episodes, drawn from `generator`. With `rows` = (lo, hi)
        only rows lo..hi-1 are drawn and reset (the generator advances as
        for n): a data-parallel rank's block."""
        return reset(self.cfg, self.draw_reset(n, generator, rows))

    def reset_batch_chunked(self, n: int, generator: Threefry,
                            chunk_max: int = 4096,
                            rows: Optional[Tuple[int, int]] = None
                            ) -> Tuple[EnvState, torch.Tensor]:
        """reset_batch in row groups of at most chunk_max, which bounds the
        peak memory of the draws and flood fields. Each group draws its own
        rows, so with one group this is reset_batch exactly. `rows` as in
        reset_batch: every group advances the generator, and only the rows
        in lo..hi-1 are drawn and reset."""
        lo, hi = rows if rows is not None else (0, n)
        num_chunks = -(-n // chunk_max)
        chunk = -(-n // num_chunks)
        parts = []
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            a, b = max(lo, c0), min(hi, c1)
            draws = self.draw_reset(c1 - c0, generator,
                                    (a - c0, b - c0) if a < b else (0, 0))
            if a < b:
                parts.append(reset(self.cfg, draws))
        if len(parts) == 1:
            return parts[0]
        states, obs = zip(*parts)
        return (EnvState(**{f.name: torch.cat([getattr(s, f.name)
                                               for s in states])
                            for f in dataclasses.fields(EnvState)}),
                torch.cat(obs))

    def autoreset(self, state: EnvState, obs: torch.Tensor, done: torch.Tensor,
                  pool_state: EnvState, pool_obs: torch.Tensor,
                  pool_ptr: torch.Tensor):
        """Swap terminated rows for fresh pool rows -> (state', obs', ptr').

        Each done row takes the next pool row, wrapping modulo the pool size.
        A 0-dim `pool_ptr` is one pointer over the whole pool; a (d,) pointer
        splits batch and pool into d equal blocks, block i drawing only from
        pool block i with its own pointer.
        """
        r = pool_state.num_rows
        if pool_ptr.dim() == 0:
            take = (pool_ptr + torch.cumsum(done.long(), 0) - 1) % r
            ptr = (pool_ptr + done.sum()) % r
        else:
            d = pool_ptr.shape[0]
            b = done.shape[0]
            if b % d or r % d:
                raise ValueError(f"batch {b} and pool {r} must split into "
                                 f"{d} blocks")
            pb = r // d
            done_b = done.reshape(d, b // d).long()
            take = ((pool_ptr[:, None] + torch.cumsum(done_b, 1) - 1) % pb
                    + pb * torch.arange(d, device=done.device)[:, None])
            take = take.reshape(b)
            ptr = (pool_ptr + done_b.sum(1)) % pb

        def pick(new, old):
            mask = done.reshape((-1,) + (1,) * (old.dim() - 1))
            return torch.where(mask, new[take], old)

        return (state.zip_map(lambda old, new: pick(new, old), pool_state),
                pick(pool_obs, obs), ptr.to(pool_ptr.dtype))

    @property
    def obs_shape(self) -> Tuple[int, ...]:
        return (self.cfg.num_agents,) + self.cfg.obs_shape

    @property
    def num_actions(self) -> int:
        return self.cfg.num_actions


def make_env(env_id: str, cfg: Optional[EnvConfig] = None,
             device="cuda") -> TrackEnv:
    """gym.make-style factory over the Track2D ids: the env of `env_id`
    (of `cfg` where given) on `device`."""
    if cfg is None:
        cfg = parse_env_id(env_id)
    return TrackEnv(cfg, device)
