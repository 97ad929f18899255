"""Greedy evaluation: N episodes, all as rows of one batch.

Port of ``active_tracking_rl_tpu/rl/evaluate.py``. Protocol: `episodes`
fresh episodes of the eval env (the config's ``env_base``), each player's
most probable action at every step, `max_steps` (500) steps. A row whose
episode ends is frozen from then on (env state, frame stack, recurrent
state), so its return and length are those of its one episode. Metrics:
per-agent R_mean and R_std, EL_mean and EL_std, R_step, and S_rate, the
share of episodes that last max_steps; the per-episode arrays beside them.

It runs on the env's device: the card unless the caller builds the env on
the CPU. The reset draws come from a ``noise.Threefry`` or are given at the
seam (``ResetDraws``, as ``TrackEnv.reset`` takes them).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from active_tracking_rl_torch.config import NetConfig
from active_tracking_rl_torch.envs.env import ResetDraws, TrackEnv
from active_tracking_rl_torch.models.dueling import DuelingModel
from active_tracking_rl_torch.ops.noise import Threefry
from active_tracking_rl_torch.rl.rollout import (obs_to_model, stack_fill,
                                                 stack_push)


def make_eval_fn(model: DuelingModel, env: TrackEnv, net_cfg: NetConfig,
                 episodes: int, max_steps: int = 500):
    """eval_fn(generator=None, draws=None) -> dict of tensors on the env's
    device. `draws` (ResetDraws of `episodes` rows) wins over `generator`."""

    @torch.no_grad()
    def eval_fn(generator: Optional[Threefry] = None,
                draws: Optional[ResetDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = env.draw_reset(episodes, generator)
        state, obs = env.reset(draws)
        obs_stack = stack_fill(obs, net_cfg.stack_frames)
        dev = obs.device
        hx = torch.zeros((episodes, 2, net_cfg.rnn_out), dtype=torch.float32,
                         device=dev)
        cx = hx.clone()
        finished = torch.zeros((episodes,), dtype=torch.bool, device=dev)
        ep_ret = torch.zeros((episodes, 2), dtype=torch.float32, device=dev)
        ep_len = torch.zeros((episodes,), dtype=torch.int32, device=dev)

        def pick(new, old):
            """`old` on the finished rows, `new` on the others."""
            return torch.where(
                finished.reshape((-1,) + (1,) * (old.dim() - 1)), old, new)

        for _ in range(max_steps):
            _, actions, _, _, hx_n, cx_n, _ = model.step_both(
                obs_to_model(obs_stack), hx, cx, None, test=True)
            state_n, obs_n, rew, done, _ = env.step(state, actions)
            live = ~finished
            ep_ret = ep_ret + rew * live[:, None]
            ep_len = ep_len + live.to(torch.int32)
            state = state_n.zip_map(pick, state)
            obs_stack = pick(stack_push(obs_stack, obs_n), obs_stack)
            hx = pick(hx_n, hx)
            cx = pick(cx_n, cx)
            finished = finished | done

        lens = ep_len.to(torch.float32)
        success = (ep_len >= max_steps).to(torch.float32)
        return {
            "R_mean": ep_ret.mean(0),
            "R_std": ep_ret.std(0, correction=0),
            "EL_mean": lens.mean(),
            "EL_std": lens.std(correction=0),
            "R_step": ep_ret.sum(0) / torch.clamp_min(ep_len.sum(), 1),
            "S_rate": success.mean(),
            "ep_returns": ep_ret,
            "ep_lens": ep_len,
            "ep_success": success,
        }

    return eval_fn


def make_evaluator(model: DuelingModel, env: TrackEnv, net_cfg: NetConfig,
                   episodes: int = 100, max_steps: int = 500):
    """evaluator(generator=None, draws=None) -> dict of host numpy arrays."""
    fn = make_eval_fn(model, env, net_cfg, episodes, max_steps)

    def evaluator(generator: Optional[Threefry] = None,
                  draws: Optional[ResetDraws] = None) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in fn(generator, draws).items()}

    return evaluator


def evaluate(model: DuelingModel, env: TrackEnv, net_cfg: NetConfig,
             generator: Optional[Threefry] = None, episodes: int = 100,
             max_steps: int = 500,
             draws: Optional[ResetDraws] = None) -> Dict[str, np.ndarray]:
    """One evaluation: make_evaluator(...)(generator, draws)."""
    return make_evaluator(model, env, net_cfg, episodes, max_steps)(
        generator, draws)
