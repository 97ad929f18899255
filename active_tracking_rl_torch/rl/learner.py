"""The synchronous learner: rollout -> loss -> gradients -> optimizer.

Port of ``active_tracking_rl_tpu/rl/learner.py``. A train step runs the
rollout, bootstraps V(s_T), computes the dueling loss averaged over rows,
backpropagates through the 20-step window and applies one clipped SharedAdam
or SharedRMSprop update to the parameters of the trained player(s). Parameters live in the
model and optimizer and are updated in place. Over a data-parallel mesh
(``parallel/mesh.py``) each rank steps its block of the rows and the
gradients are averaged over the ranks before the update.
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
from active_tracking_rl_torch.parallel.mesh import Mesh
from active_tracking_rl_torch.rl.optim import global_norm, make_optimizer_for
from active_tracking_rl_torch.rl.rollout import (TrainCarry, Trajectory,
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
                    generator: noise_mod.Threefry, device,
                    rows: Optional[Tuple[int, int]] = None) -> StepNoise:
    """The step's noise for `num_envs` rows (rows lo..hi-1 of it with
    `rows`; the generator advances as for all)."""
    return StepNoise(
        draw_action_noise(num_steps, num_envs, num_actions, generator, device,
                          rows),
        noise_mod.gumbel((num_envs, num_actions), generator, device, rows))


def metric_sums(loss: torch.Tensor, stats, traj: Trajectory,
                num_steps: int) -> torch.Tensor:
    """The step's metrics as one float32 vector of terms that add over
    data-parallel ranks: the rank's means over rows (loss, policy, value,
    entropy, pred; 8 entries) and its episode sums (return, length, count;
    4 entries)."""
    return torch.cat([
        loss.detach().reshape(1), stats.policy_loss.detach().mean(0),
        stats.value_loss.detach().mean(0),
        stats.entropy.detach().mean(0) / num_steps,
        stats.pred_loss.detach().mean().reshape(1),
        traj.ep_return.sum((0, 1)),
        traj.ep_len.sum().to(torch.float32).reshape(1),
        traj.done.sum().to(torch.float32).reshape(1)])


def step_metrics(sums: torch.Tensor, world: int,
                 grad_norm: torch.Tensor) -> TrainMetrics:
    """TrainMetrics from `metric_sums` summed over `world` ranks: the means
    over rows are averaged over the ranks (equal blocks), and the episode
    return and length are the global sums over the global episode count
    (a mean of the ranks' own ratios would be another number)."""
    means, (ret0, ret1, ep_len, ep_count) = sums[:8] / world, sums[8:]
    denom = torch.clamp_min(ep_count, 1.0)
    return TrainMetrics(
        loss=means[0], policy_loss=means[1:3], value_loss=means[3:5],
        entropy=means[5:7], pred_loss=means[7],
        ep_return=torch.stack([ret0, ret1]) / denom, ep_len=ep_len / denom,
        ep_count=ep_count, grad_norm=grad_norm)


def make_train_step(model: DuelingModel, env: TrackEnv, net_cfg: NetConfig,
                    tcfg: TrainConfig, opt: torch.optim.Optimizer,
                    pool_blocks: int = 1, mesh: Mesh = Mesh()):
    """train_step(carry, mode, pool=None, noise=None) -> (carry', metrics, ptr').

    `mode` is the loss's train mode (0 tracker, 1 target, else both).
    `pool` is (pool_state, pool_obs, pool_ptr) from `make_pool_fn` and
    `init_pool_ptr`; thread the returned pointer back in while the pool is
    reused. None generates a fresh pool inside the step (pool refresh 1).
    `noise` is the step's sampling noise; None draws it from the carry's
    generator. Track2D's actions are discrete: a continuous network trains
    on host envs with Box actions (``rl/host_loop.py``).

    `pool_blocks` d > 1: blocked autoreset (``run_rollout``), the pointer
    a (d,) tensor; one process only. `mesh`: this process is one of W
    data-parallel ranks and `carry` holds its block of the tcfg.num_envs
    rows. Every rank's generator takes the global step's counters (the
    same on every rank) and hashes only its own rows' (the action and
    bootstrap noise of its rows, the draws of its block of the pool), so
    its draws are those rows of the global draw; it resets only its
    block of the pool, and its gradients and metric sums are reduced over
    the ranks in one all-reduce. W ranks so compute what one process
    computes with pool_blocks = W, and every rank's generator stays in one
    state. `noise`, if given, is the global step's. The default ``Mesh()``
    is one process: W = 1, no collectives.
    """
    if net_cfg.continuous:
        raise ValueError(f"network {net_cfg.name!r}: the Track2D learner "
                         f"takes discrete actions; continuous heads train "
                         f"through rl/host_loop.py (run/train_host.py)")
    if mesh.world > 1 and pool_blocks != 1:
        raise ValueError("a rank's pool is its own block: pool_blocks must "
                         "be 1 over several ranks")

    def train_step(carry: TrainCarry, mode: int,
                   pool: Optional[Tuple[EnvState, torch.Tensor,
                                        torch.Tensor]] = None,
                   noise: Optional[StepNoise] = None):
        pool_ptr = None
        if pool is not None:
            pool, pool_ptr = pool[:2], pool[2]
        n = carry.obs_stack.shape[0] * mesh.world
        lo, hi = mesh.rows(n)
        if noise is None:
            noise = draw_step_noise(tcfg.num_steps, n, env.num_actions,
                                    carry.generator, env.device, (lo, hi))
        else:
            noise = StepNoise(noise.actions[:, lo:hi], noise.bootstrap[lo:hi])
        if pool is None:
            pool = env.reset_batch(tcfg.reset_pool, carry.generator,
                                   mesh.rows(tcfg.reset_pool))
        model.zero_grad(set_to_none=True)
        traj, new_carry, ptr = run_rollout(model, env, tcfg, carry, pool,
                                           pool_ptr, noise.actions,
                                           pool_blocks)
        boot = bootstrap_values(model, new_carry, noise.bootstrap)
        stats = dueling_loss(traj.rewards, traj.values, boot, traj.log_probs,
                             traj.entropies, traj.done, mode, tcfg.gamma,
                             tcfg.tau, tcfg.entropy, tcfg.entropy_target,
                             traj.r_pred)
        loss = stats.loss.mean()
        loss.backward()
        sums = mesh.average_grads_(
            model.parameters(),
            metric_sums(loss, stats, traj, tcfg.num_steps))
        grad_norm = global_norm(p.grad for p in model.parameters()
                                if p.grad is not None)
        opt.step()

        new_carry.hx = new_carry.hx.detach()
        new_carry.cx = new_carry.cx.detach()
        return new_carry, step_metrics(sums, mesh.world, grad_norm), ptr

    return train_step


def init_pool_ptr(pool_blocks: int = 1, device="cuda") -> torch.Tensor:
    """Fresh autoreset pointer(s) for a newly generated pool."""
    shape = () if pool_blocks == 1 else (pool_blocks,)
    return torch.zeros(shape, dtype=torch.int64, device=device)


def make_pool_fn(env: TrackEnv, tcfg: TrainConfig, mesh: Mesh = Mesh()):
    """pool_fn(generator) -> (EnvState[P], obs[P]): the reset pool; over
    several ranks, this rank's block of it (the generator advances as for
    all P rows)."""
    rows = mesh.rows(tcfg.reset_pool)

    def pool_fn(generator: noise_mod.Threefry):
        return env.reset_batch(tcfg.reset_pool, generator, rows)

    return pool_fn


class LearnerState(NamedTuple):
    model: DuelingModel
    opt: torch.optim.Optimizer
    carry: TrainCarry


def init_learner(model: DuelingModel, env: TrackEnv, net_cfg: NetConfig,
                 tcfg: TrainConfig, generator: noise_mod.Threefry,
                 mesh: Mesh = Mesh()) -> LearnerState:
    """Initialize the model's parameters, the optimizer and the env carry,
    all from `generator` (which the carry then keeps). Over several ranks
    the carry is this rank's block of the tcfg.num_envs rows (the
    generator advances as for all) and the parameters are rank 0's."""
    model.reset_parameters(generator)
    mesh.broadcast_(model.parameters())
    opt = make_optimizer_for(model, tcfg)
    carry = init_carry(env, net_cfg, tcfg.num_envs, generator,
                       rows=mesh.rows(tcfg.num_envs))
    return LearnerState(model, opt, carry)
