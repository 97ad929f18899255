"""The on-device rollout: T env steps for all rows, differentiable through
the model forwards.

Port of ``active_tracking_rl_tpu/rl/rollout.py``. Per step: the tracker
samples, then the target; the env steps (a scripted target follows its
tape); terminated rows take fresh episodes from the reset pool, with their
frame stack refilled and their recurrent state zeroed. The carry's
recurrent state enters detached, which truncates BPTT at the rollout
boundary. A TAT target's predictions of the tracker's reward are kept for
the aux loss.

With ``tcfg.remat`` each step's model forward runs under
``torch.utils.checkpoint``: autograd keeps only its inputs (the uint8 frame
stack, h, c and the step's noise) and the backward pass recomputes the
forward from them, which gives the same gradients bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from active_tracking_rl_torch.config import NetConfig, TrainConfig
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.envs.types import EnvState
from active_tracking_rl_torch.models.dueling import DuelingModel
from active_tracking_rl_torch.ops import noise as noise_mod


@dataclasses.dataclass
class TrainCarry:
    """Persistent across learner iterations."""

    env_state: EnvState            # EnvState[B]
    obs_stack: torch.Tensor        # (B, 2, k, H, W) uint8
    hx: torch.Tensor               # (B, 2, R) float32
    cx: torch.Tensor               # (B, 2, R) float32
    generator: noise_mod.Threefry     # every draw of the next iterations


class Trajectory(NamedTuple):
    values: torch.Tensor           # (T, B, 2)
    log_probs: torch.Tensor        # (T, B, 2)
    entropies: torch.Tensor        # (T, B, 2)
    rewards: torch.Tensor          # (T, B, 2)
    done: torch.Tensor             # (T, B)
    r_pred: Optional[torch.Tensor]  # (T, B) TAT aux head, else None
    ep_return: torch.Tensor        # (T, B, 2) c_reward where done, else 0
    ep_len: torch.Tensor           # (T, B) t where done, else 0


def stack_push(obs_stack: torch.Tensor, new_obs: torch.Tensor) -> torch.Tensor:
    """Drop the oldest frame and append `new_obs` (B, 2, H, W)."""
    return torch.cat([obs_stack[:, :, 1:], new_obs[:, :, None]], dim=2)


def stack_fill(new_obs: torch.Tensor, k: int) -> torch.Tensor:
    """All k frames set to `new_obs`."""
    return new_obs[:, :, None].repeat(1, 1, k, 1, 1)


def obs_to_model(obs_stack: torch.Tensor) -> torch.Tensor:
    """(B, 2, k, H, W) uint8 -> (B, 2, k, H, W, 1) float32."""
    return obs_stack.to(torch.float32)[..., None]


def init_carry(env: TrackEnv, net_cfg: NetConfig, num_envs: int,
               generator: noise_mod.Threefry, chunk_max: int = 4096,
               rows: Optional[Tuple[int, int]] = None) -> TrainCarry:
    """The carry of `num_envs` fresh episodes; with `rows` = (lo, hi) only
    rows lo..hi-1 (a rank's block; the generator advances as for all)."""
    state, obs = env.reset_batch_chunked(num_envs, generator, chunk_max,
                                         rows)
    hx = torch.zeros((state.num_rows, 2, net_cfg.rnn_out),
                     dtype=torch.float32, device=env.device)
    return TrainCarry(state, stack_fill(obs, net_cfg.stack_frames), hx,
                      hx.clone(), generator)


def draw_action_noise(num_steps: int, num_envs: int, num_actions: int,
                      generator: noise_mod.Threefry, device,
                      rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(T, B, 2, A) Gumbel noise: each player's sampling noise per step
    (with `rows` = (lo, hi), the block of rows lo..hi-1 of B)."""
    return noise_mod.gumbel((num_steps, num_envs, 2, num_actions), generator,
                            device, rows, dim=1)


def run_rollout(model: DuelingModel, env: TrackEnv, tcfg: TrainConfig,
                carry: TrainCarry, pool: Optional[Tuple[EnvState,
                                                        torch.Tensor]] = None,
                pool_ptr: Optional[torch.Tensor] = None,
                action_noise: Optional[torch.Tensor] = None,
                pool_blocks: int = 1
                ) -> Tuple[Trajectory, TrainCarry, torch.Tensor]:
    """T = tcfg.num_steps steps for all rows -> (traj, carry', pool_ptr').

    `pool`: the reset pool (state, obs); None generates tcfg.reset_pool fresh
    rows from the carry's generator. `pool_ptr`: the autoreset pointer to
    start from (a pool reused across iterations must thread it; None is 0).
    `action_noise`: (T, B, 2, A) Gumbel noise; None draws it.
    `pool_blocks` d > 1: batch and pool split into d blocks, block i taking
    its resets from pool block i under its own pointer (env.autoreset with
    a (d,) pointer): what d data-parallel ranks compute, in one process.
    """
    gen = carry.generator
    if pool is None:
        pool = env.reset_batch(tcfg.reset_pool, gen)
    pool_state, pool_obs = pool
    b = carry.obs_stack.shape[0]
    if action_noise is None:
        action_noise = draw_action_noise(tcfg.num_steps, b, env.num_actions,
                                         gen, env.device)
    ptr = (torch.zeros(() if pool_blocks == 1 else (pool_blocks,),
                       dtype=torch.int64, device=env.device)
           if pool_ptr is None else pool_ptr)

    def model_step(obs_stack, hx, cx, noise):
        return model.step_both(obs_to_model(obs_stack), hx, cx, noise)

    if tcfg.remat and torch.is_grad_enabled():
        # the forward draws nothing, so no RNG state needs keeping
        model_step = functools.partial(checkpoint, model_step,
                                       use_reentrant=False,
                                       preserve_rng_state=False)

    env_state, obs_stack = carry.env_state, carry.obs_stack
    hx, cx = carry.hx.detach(), carry.cx.detach()
    k = obs_stack.shape[2]
    outs, r_preds = [], []
    for t in range(tcfg.num_steps):
        (values, actions, entropies, log_probs, hx, cx,
         r_pred) = model_step(obs_stack, hx, cx, action_noise[t])
        r_preds.append(r_pred)
        env_state, obs, rewards, done, _ = env.step(env_state, actions)
        ep_return = torch.where(done[:, None], env_state.c_reward, 0.0)
        ep_len = torch.where(done, env_state.t, 0)
        env_state, obs2, ptr = env.autoreset(env_state, obs, done, pool_state,
                                             pool_obs, ptr)
        obs_stack = torch.where(done[:, None, None, None, None],
                                stack_fill(obs2, k), stack_push(obs_stack, obs2))
        zero = done[:, None, None]
        hx = torch.where(zero, 0.0, hx)
        cx = torch.where(zero, 0.0, cx)
        outs.append((values, log_probs, entropies, rewards, done, ep_return,
                     ep_len))

    (values, log_probs, entropies, rewards, done, ep_return,
     ep_len) = (torch.stack(x) for x in zip(*outs))
    aux = model.cfg.tat and model.cfg.aux_reward
    r_pred = torch.stack(r_preds)[..., 0] if aux else None
    traj = Trajectory(values, log_probs, entropies, rewards, done, r_pred,
                      ep_return, ep_len)
    return traj, TrainCarry(env_state, obs_stack, hx, cx, gen), ptr
