"""The synchronous learner: rollout -> loss -> gradients -> optimizer.

Port of ``active_tracking_rl_tpu/rl/learner.py``. A train step runs the
rollout, bootstraps V(s_T), computes the dueling loss averaged over rows,
backpropagates through the 20-step window and applies one clipped SharedAdam
or SharedRMSprop update to the parameters of the trained player(s). Parameters live in the
model and optimizer and are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from active_tracking_rl_torch.config import NetConfig, TrainConfig
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.envs.types import EnvState
from active_tracking_rl_torch.models.dueling import DuelingModel
from active_tracking_rl_torch.ops import noise as noise_mod
from active_tracking_rl_torch.ops.losses import dueling_loss
from active_tracking_rl_torch.rl.optim import global_norm, make_optimizer_for
from active_tracking_rl_torch.rl.rollout import (TrainCarry,
                                                 draw_action_noise, init_carry,
                                                 obs_to_model, run_rollout)


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor    # (2,)
    value_loss: torch.Tensor     # (2,)
    entropy: torch.Tensor        # (2,)
    pred_loss: torch.Tensor      # mean over rows of the aux L1 loss
    ep_return: torch.Tensor      # (2,) mean return of episodes finished this iter
    ep_len: torch.Tensor
    ep_count: torch.Tensor
    grad_norm: torch.Tensor      # over all parameters, before clipping


class StepNoise(NamedTuple):
    """All sampling noise of one train step."""

    actions: torch.Tensor        # (T, B, 2, A) Gumbel
    bootstrap: torch.Tensor      # (B, A) Gumbel: the tracker's action at s_T


@torch.no_grad()
def bootstrap_values(model: DuelingModel, carry: TrainCarry,
                     gumbel: torch.Tensor) -> torch.Tensor:
    """V(s_T) for both players, (B, 2). The target's value is conditioned on
    a fresh tracker sample at s_T, drawn by `gumbel` (a TAT target reads it;
    a plain one does not)."""
    obs_f = obs_to_model(carry.obs_stack)
    out0 = model.tracker_fwd(obs_f[:, 0], carry.hx[:, 0], carry.cx[:, 0])
    s0 = model.sample(out0, gumbel)
    out1 = model.target_fwd(obs_f[:, 0], obs_f[:, 1], carry.hx[:, 1],
                            carry.cx[:, 1], s0.action)
    return torch.cat([out0.value, out1.value], dim=-1)


def draw_step_noise(num_steps: int, num_envs: int, num_actions: int,
                    generator: torch.Generator, device) -> StepNoise:
    return StepNoise(
        draw_action_noise(num_steps, num_envs, num_actions, generator, device),
        noise_mod.gumbel((num_envs, num_actions), generator, device))


def make_train_step(model: DuelingModel, env: TrackEnv, net_cfg: NetConfig,
                    tcfg: TrainConfig, opt: torch.optim.Optimizer):
    """train_step(carry, mode, pool=None, noise=None) -> (carry', metrics, ptr').

    `mode` is the loss's train mode (0 tracker, 1 target, else both).
    `pool` is (pool_state, pool_obs, pool_ptr) from `make_pool_fn` and
    `init_pool_ptr`; thread the returned pointer back in while the pool is
    reused. None generates a fresh pool inside the step (pool refresh 1).
    `noise` is the step's sampling noise; None draws it from the carry's
    generator. Track2D's actions are discrete: a continuous network trains
    on host envs with Box actions (``rl/host_loop.py``).
    """
    if net_cfg.continuous:
        raise ValueError(f"network {net_cfg.name!r}: the Track2D learner "
                         f"takes discrete actions; continuous heads train "
                         f"through rl/host_loop.py (run/train_host.py)")

    def train_step(carry: TrainCarry, mode: int,
                   pool: Optional[Tuple[EnvState, torch.Tensor,
                                        torch.Tensor]] = None,
                   noise: Optional[StepNoise] = None):
        pool_ptr = None
        if pool is not None:
            pool, pool_ptr = pool[:2], pool[2]
        if noise is None:
            noise = draw_step_noise(tcfg.num_steps, carry.obs_stack.shape[0],
                                    env.num_actions, carry.generator,
                                    env.device)
        model.zero_grad(set_to_none=True)
        traj, new_carry, ptr = run_rollout(model, env, tcfg, carry, pool,
                                           pool_ptr, noise.actions)
        boot = bootstrap_values(model, new_carry, noise.bootstrap)
        stats = dueling_loss(traj.rewards, traj.values, boot, traj.log_probs,
                             traj.entropies, traj.done, mode, tcfg.gamma,
                             tcfg.tau, tcfg.entropy, tcfg.entropy_target,
                             traj.r_pred)
        loss = stats.loss.mean()
        loss.backward()
        grad_norm = global_norm(p.grad for p in model.parameters()
                                if p.grad is not None)
        opt.step()

        new_carry.hx = new_carry.hx.detach()
        new_carry.cx = new_carry.cx.detach()
        ep_count = traj.done.sum().to(torch.float32)
        denom = torch.clamp_min(ep_count, 1.0)
        metrics = TrainMetrics(
            loss=loss.detach(),
            policy_loss=stats.policy_loss.detach().mean(0),
            value_loss=stats.value_loss.detach().mean(0),
            entropy=stats.entropy.detach().mean(0) / tcfg.num_steps,
            pred_loss=stats.pred_loss.detach().mean(),
            ep_return=traj.ep_return.sum((0, 1)) / denom,
            ep_len=traj.ep_len.sum().to(torch.float32) / denom,
            ep_count=ep_count,
            grad_norm=grad_norm,
        )
        return new_carry, metrics, ptr

    return train_step


def init_pool_ptr(pool_blocks: int = 1, device="cuda") -> torch.Tensor:
    """Fresh autoreset pointer(s) for a newly generated pool."""
    shape = () if pool_blocks == 1 else (pool_blocks,)
    return torch.zeros(shape, dtype=torch.int64, device=device)


def make_pool_fn(env: TrackEnv, tcfg: TrainConfig):
    """pool_fn(generator) -> (EnvState[P], obs[P]): the reset pool."""

    def pool_fn(generator: torch.Generator):
        return env.reset_batch(tcfg.reset_pool, generator)

    return pool_fn


class LearnerState(NamedTuple):
    model: DuelingModel
    opt: torch.optim.Optimizer
    carry: TrainCarry


def init_learner(model: DuelingModel, env: TrackEnv, net_cfg: NetConfig,
                 tcfg: TrainConfig, generator: torch.Generator
                 ) -> LearnerState:
    """Initialize the model's parameters, the optimizer and the env carry,
    all from `generator` (which the carry then keeps)."""
    model.reset_parameters(generator)
    opt = make_optimizer_for(model, tcfg)
    carry = init_carry(env, net_cfg, tcfg.num_envs, generator)
    return LearnerState(model, opt, carry)
