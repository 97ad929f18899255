"""Host-env training loop: any env with the gym API (the external 3D
family, or Track2D through ``envs/bridge.py``) behind the same model, loss
and optimizer as the on-device learner.

Port of ``active_tracking_rl_tpu/rl/host_loop.py``. The split: **act** on
the model's device (one ``step_both`` per env step over the whole
``HostEnvPool`` batch, without autograd), **step** the B envs on the host
(``HostEnvPool``), and **update** by teacher-forced replay: a loop over the
T stored steps re-runs the model on the stored (obs, action) sequence with
autograd, which reproduces the acting pass's log-probs and values (same
parameters, same inputs), then the dueling loss per row, its mean over rows,
the backward pass and one clipped optimizer step.

Randomness enters as tensors (``HostNoise``): the acting pass's noise per
step and player, and the bootstrap's noise for the TAT target's fresh
tracker action at s_T; Gumbel noise for discrete heads, standard normal for
continuous ones. ``HostTrainer`` draws them on the host from its
generator unless a caller gives them.

For Track2D the on-device learner (``rl/learner.py``) is far faster; this
loop exists so that any env that only speaks the host gym API trains on
the card with no other code change.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from active_tracking_rl_torch.config import NetConfig, TrainConfig
from active_tracking_rl_torch.models.dueling import DuelingModel
from active_tracking_rl_torch.models.heads import (eval_continuous,
                                                   eval_discrete)
from active_tracking_rl_torch.ops import noise as noise_mod
from active_tracking_rl_torch.ops.losses import dueling_loss
from active_tracking_rl_torch.rl.learner import TrainMetrics
from active_tracking_rl_torch.rl.optim import global_norm, make_optimizer_for


class HostBatch(NamedTuple):
    """One T-step host rollout, stacked time-major, on the model's device."""

    obs: torch.Tensor        # (T+1, B, P, k, H, W, 1) f32 (T+1 for bootstrap)
    actions: torch.Tensor    # (T, B, P) int64 | (T, B, P, A) f32 raw samples
    rewards: torch.Tensor    # (T, B, 2) f32
    done: torch.Tensor       # (T, B) bool
    hx0: torch.Tensor        # (B, P, R) recurrent state before step 0
    cx0: torch.Tensor


class HostNoise(NamedTuple):
    """All sampling noise of one train iteration."""

    actions: torch.Tensor    # (T, B, 2, A): each player's noise per step
    bootstrap: torch.Tensor  # (B, A): the tracker's fresh action at s_T


def wrap_action(action: np.ndarray, low, high) -> np.ndarray:
    """Rescale a [-1, 1] policy action to the env's [low, high] box; it is
    applied to the clamped action."""
    low = np.asarray(low, np.float32)
    high = np.asarray(high, np.float32)
    return np.asarray(action) * (high - low) / 2.0 + (high + low) / 2.0


def _obs_to_model(obs: np.ndarray, channel_first: bool = True) -> np.ndarray:
    """(B, P, k, ...) uint8/float -> (B, P, k, H, W, C) float32.

    `channel_first` states the pool's per-frame layout (the create_env
    wrapper chain yields channel-first (C, H, W) frames; the encoders are
    channel-last). Channel-less (B, P, k, H, W) input gets a trailing channel
    axis either way; 6-dim input is transposed only when channel_first.
    """
    o = np.asarray(obs, np.float32)
    if o.ndim == 5:                       # (B, P, k, H, W) -> add channel
        o = o[..., None]
    elif o.ndim == 6 and channel_first:   # (B, P, k, C, H, W)
        o = np.moveaxis(o, 3, -1)
    return o


def draw_host_noise(net_cfg: NetConfig, num_steps: int, num_envs: int,
                    num_actions: int, generator: noise_mod.Threefry,
                    device) -> HostNoise:
    """Gumbel (discrete) or standard normal (continuous) noise."""
    if net_cfg.continuous:
        def draw(shape):
            return noise_mod.normal(shape, generator, device)
    else:
        def draw(shape):
            return noise_mod.gumbel(shape, generator, device)
    return HostNoise(draw((num_steps, num_envs, 2, num_actions)),
                     draw((num_envs, num_actions)))


def _replay(model: DuelingModel, batch: HostBatch, two_player: bool):
    """Teacher-forced forward over the stored sequence.

    Returns (values, log_probs, entropies) each (T, B, 2) (lane 1 zero in
    single-player mode), r_pred (T, B) and the recurrent state after the
    last step, (hx, cx).
    """
    cont = model.cfg.continuous

    def eval_out(out, action):
        if cont:
            ent, lp = eval_continuous(out.logits, out.sigma, action)
            # per agent, the mean over action dims
            return ent.mean(-1, keepdim=True), lp.mean(-1, keepdim=True)
        return eval_discrete(out.logits, action)

    hx, cx = batch.hx0, batch.cx0
    values, lps, ents, rps = [], [], [], []
    for t in range(batch.actions.shape[0]):
        obs_t, a_t = batch.obs[t], batch.actions[t]
        out0 = model.tracker_fwd(obs_t[:, 0], hx[:, 0], cx[:, 0])
        ent0, lp0 = eval_out(out0, a_t[:, 0])
        rp = torch.zeros_like(lp0[..., 0])
        if two_player:
            # a TAT target is conditioned on the clamped action (the stored
            # continuous actions are raw)
            a0 = torch.clamp(a_t[:, 0], -1.0, 1.0) if cont else a_t[:, 0]
            out1 = model.target_fwd(obs_t[:, 0], obs_t[:, 1], hx[:, 1],
                                    cx[:, 1], a0)
            ent1, lp1 = eval_out(out1, a_t[:, 1])
            v1, outs = out1.value, (out0, out1)
            if out1.r_pred is not None:
                rp = out1.r_pred[..., 0]
        else:
            v1 = ent1 = lp1 = torch.zeros_like(out0.value)
            outs = (out0,)
        values.append(torch.cat([out0.value, v1], -1))
        lps.append(torch.cat([lp0, lp1], -1))
        ents.append(torch.cat([ent0, ent1], -1))
        rps.append(rp)
        # an episode boundary zeroes the recurrent state
        done = batch.done[t][:, None, None]
        hx = torch.where(done, 0.0, torch.stack([o.h for o in outs], 1))
        cx = torch.where(done, 0.0, torch.stack([o.c for o in outs], 1))
    return (torch.stack(values), torch.stack(lps), torch.stack(ents),
            torch.stack(rps), (hx, cx))


def make_host_update(model: DuelingModel, net_cfg: NetConfig,
                     tcfg: TrainConfig, opt: torch.optim.Optimizer,
                     two_player: bool):
    """update(batch, mode, bootstrap_noise) -> TrainMetrics; updates the
    model's parameters and `opt` in place."""
    aux = net_cfg.tat and net_cfg.aux_reward and two_player

    def update(batch: HostBatch, mode: int,
               bootstrap_noise: torch.Tensor) -> TrainMetrics:
        model.zero_grad(set_to_none=True)
        values, lps, ents, rp, (hx, cx) = _replay(model, batch, two_player)
        # V(s_T); the TAT target's value at a fresh tracker action
        obs_t = batch.obs[-1]
        out0 = model.tracker_fwd(obs_t[:, 0], hx[:, 0], cx[:, 0])
        if two_player:
            s0 = model.sample(out0, bootstrap_noise)
            out1 = model.target_fwd(obs_t[:, 0], obs_t[:, 1], hx[:, 1],
                                    cx[:, 1], s0.action)
            boot = torch.cat([out0.value, out1.value], -1)
        else:
            boot = torch.cat([out0.value, torch.zeros_like(out0.value)], -1)
        stats = dueling_loss(batch.rewards, values, boot, lps, ents,
                             batch.done, mode, tcfg.gamma, tcfg.tau,
                             tcfg.entropy, tcfg.entropy_target,
                             rp if aux else None)
        loss = stats.loss.mean()
        loss.backward()
        grad_norm = global_norm(p.grad for p in model.parameters()
                                if p.grad is not None)
        opt.step()
        zeros2 = torch.zeros((2,), device=loss.device)
        return TrainMetrics(
            loss=loss.detach(),
            policy_loss=stats.policy_loss.detach().mean(0),
            value_loss=stats.value_loss.detach().mean(0),
            entropy=stats.entropy.detach().mean(0) / tcfg.num_steps,
            pred_loss=stats.pred_loss.detach().mean(),
            ep_return=zeros2, ep_len=zeros2[0],
            ep_count=batch.done.sum().to(torch.float32),
            grad_norm=grad_norm)

    return update


class HostTrainer:
    """Drives a HostEnvPool with the act and update steps.

    `pool` yields per-env obs shaped (P, k, ...) (the create_env wrapper
    chain's FrameStack output) and takes per-env action rows (P,), or, for
    a single-player model, the env's own action. The model's parameters
    are initialized from `seed`; the sampling noise is drawn from a
    generator seeded with seed + 1. Both are drawn on the host, as the env
    steps are, so that one seed is one run on the CPU and on the card (up
    to float rounding).
    """

    def __init__(self, model: DuelingModel, net_cfg: NetConfig,
                 tcfg: TrainConfig, pool, seed: int = 0,
                 channel_first: bool = True,
                 action_low=None, action_high=None):
        self.model = model
        self.ncfg = net_cfg
        self.tcfg = tcfg
        self.pool = pool
        self.channel_first = channel_first
        # Box bounds of continuous actions for wrap_action; None keeps the
        # clamped actions in [-1, 1]
        self.action_low = action_low
        self.action_high = action_high
        self.two_player = model.player1 is not None
        self.device = next(model.parameters()).device
        model.to("cpu").reset_parameters(noise_mod.generator(seed, "cpu"))
        model.to(self.device)
        self.opt = make_optimizer_for(model, tcfg)
        self.generator = noise_mod.generator(seed + 1, "cpu")
        self._update = make_host_update(model, net_cfg, tcfg, self.opt,
                                        self.two_player)
        b = len(pool)
        p = 2 if self.two_player else 1
        self.hx = torch.zeros((b, p, net_cfg.rnn_out), device=self.device)
        self.cx = torch.zeros_like(self.hx)
        self.obs = _obs_to_model(pool.reset(), channel_first)
        self.ep_returns = np.zeros((b,), np.float64)
        self.ep_lens = np.zeros((b,), np.int64)
        self.finished_returns: list = []
        self.finished_lens: list = []

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def train_iter(self, mode: int = 0,
                   noise: Optional[HostNoise] = None) -> TrainMetrics:
        """One T-step rollout and one update; `noise` None draws it."""
        T = self.tcfg.num_steps
        if noise is None:
            noise = HostNoise(*(x.to(self.device) for x in draw_host_noise(
                self.ncfg, T, len(self.pool), self.model.num_actions,
                self.generator, "cpu")))
        obs_seq = [self.obs]
        acts, rews, dones = [], [], []
        hx0, cx0 = self.hx, self.cx
        for t in range(T):
            with torch.no_grad():
                (_, actions, _, _, self.hx, self.cx, _) = \
                    self.model.step_both(self._tensor(self.obs), self.hx,
                                         self.cx, noise.actions[t])
            a_host = actions.cpu().numpy()
            a_env = self._env_actions(a_host)
            obs, r, done, _ = self.pool.step(a_env)
            r = self._widen_rewards(r)
            self.obs = _obs_to_model(obs, self.channel_first)
            self._count_episodes(r, done)
            done_t = self._tensor(np.asarray(done))[:, None, None]
            self.hx = torch.where(done_t, 0.0, self.hx)
            self.cx = torch.where(done_t, 0.0, self.cx)
            obs_seq.append(self.obs)
            acts.append(a_host)
            rews.append(r)
            dones.append(done)
        batch = HostBatch(
            obs=self._tensor(np.stack(obs_seq)),
            actions=self._tensor(np.stack(acts)),
            rewards=self._tensor(np.stack(rews)),
            done=self._tensor(np.stack(dones)),
            hx0=hx0, cx0=cx0)
        return self._update(batch, mode, noise.bootstrap)

    def _env_actions(self, a_host: np.ndarray) -> np.ndarray:
        a_env = a_host
        if self.ncfg.continuous:
            # stored actions are the raw samples (for replay); the env gets
            # them clamped and rescaled to its box
            a_env = np.clip(a_host, -1.0, 1.0)
            if self.action_low is not None:
                a_env = wrap_action(a_env, self.action_low, self.action_high)
        if not self.two_player:
            # a single-agent env takes its own action, not a 1-list
            a_env = a_env[:, 0]
        return a_env

    def _widen_rewards(self, r) -> np.ndarray:
        """(B,) or (B, 1) or (B, 2) rewards -> (B, 2): a single player's
        second lane is 0; one reward of two players is zero-sum."""
        r = np.asarray(r, np.float32)
        if r.ndim == 1:
            r = r[:, None]
        if not self.two_player:
            return np.concatenate([r[:, :1], np.zeros_like(r[:, :1])], 1)
        if r.shape[1] == 1:
            return np.concatenate([r, -r], 1)
        return r

    def _count_episodes(self, r: np.ndarray, done) -> None:
        self.ep_returns += r[:, 0]
        self.ep_lens += 1
        for i, d in enumerate(done):
            if d:
                self.finished_returns.append(self.ep_returns[i])
                self.finished_lens.append(self.ep_lens[i])
                self.ep_returns[i] = 0.0
                self.ep_lens[i] = 0
