"""The dueling A2C learner of AD-VAT, plain: a CNN (conv 16 and conv 32,
3 x 3, stride 2, relu; fc 256, relu) and an LSTM cell of 128 per player,
value and policy heads, Gumbel-max sampling, a 20-step rollout over the
env batch, GAE returns (gamma 0.9, tau 1), the dueling loss, one backward
and SharedAdam (amsgrad, eps 1e-3) after clipping at global norm 50. The
tracker-aware target (TAT) sees both agents' frames, adds an embedding of
the tracker's one-hot action to its features and predicts the tracker's
reward (its L1 loss joins the loss when the target trains).

``run_reference`` follows a run of the program from its seed through its
first steps and returns what the check compares: each step's loss, the
first clipped gradient of every parameter, and each parameter's change
over the steps. Parameters carry the program's names, so that the two
line up leaf by leaf; nothing is taken from the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference import threefry as tf
from benchmark.reference import track2d

#: each conv of the encoder: (out channels, kernel, stride, padding)
CONVS = ((16, 3, 2, 1), (32, 3, 2, 1))
FC = 256
HIDDEN = 128


def _uniform(shape, bound: float, gen) -> torch.Tensor:
    return tf.uniform(shape, gen, low=-bound, high=bound)


def init_player(prefix: str, frames: int, obs: int, actions: int, tat: bool,
                gen, device) -> Dict[str, torch.Tensor]:
    """One player's parameters, drawn in the program's order: U(-b, b)
    with b = sqrt(6 / (fan_in + fan_out)) for convs and dense layers,
    U(-1/sqrt(H), 1/sqrt(H)) for the cell's weights, zero biases."""
    p = {}
    cin, side = 1, obs
    for i, (cout, k, stride, pad) in enumerate(CONVS):
        b = math.sqrt(6.0 / (cin * k * k + k * k * cout))
        p[f"encoder.conv{i}.weight"] = _uniform((cout, cin, k, k), b, gen)
        p[f"encoder.conv{i}.bias"] = torch.zeros(cout)
        cin, side = cout, (side + 2 * pad - k) // stride + 1

    def dense(name, fan_in, fan_out):
        b = math.sqrt(6.0 / (fan_in + fan_out))
        p[f"{name}.weight"] = _uniform((fan_out, fan_in), b, gen)
        p[f"{name}.bias"] = torch.zeros(fan_out)

    dense("encoder.fc", frames * side * side * cin, FC)
    b = 1.0 / math.sqrt(HIDDEN)
    p["lstm.weight_ih"] = _uniform((4 * HIDDEN, FC), b, gen)
    p["lstm.weight_hh"] = _uniform((4 * HIDDEN, HIDDEN), b, gen)
    p["lstm.bias_ih"] = torch.zeros(4 * HIDDEN)
    p["lstm.bias_hh"] = torch.zeros(4 * HIDDEN)
    dense("value", HIDDEN, 1)
    dense("policy", HIDDEN, actions)
    if tat:
        dense("fc_action_tracker", actions, FC)
        dense("reward_aux", HIDDEN, 1)
    return {f"{prefix}.{k}": v.to(device) for k, v in p.items()}


def encode(p, pre: str, x: torch.Tensor) -> torch.Tensor:
    """(B, k, H, W) frames -> (B, 256) features: each frame through the
    convs, the frames' features flattened (frame, row, col, channel)."""
    b, k = x.shape[:2]
    x = x.reshape((b * k, 1) + x.shape[2:])
    for i, (_, _, stride, pad) in enumerate(CONVS):
        x = torch.relu(F.conv2d(x, p[f"{pre}.encoder.conv{i}.weight"],
                                p[f"{pre}.encoder.conv{i}.bias"], stride,
                                pad))
    x = x.permute(0, 2, 3, 1).reshape(b, -1)
    return torch.relu(F.linear(x, p[f"{pre}.encoder.fc.weight"],
                               p[f"{pre}.encoder.fc.bias"]))


def player(p, pre: str, frames, h, c, tracker_action=None, actions: int = 4):
    """-> (value (B,1), logits (B,A), h', c', reward prediction or None)."""
    x = encode(p, pre, frames)
    if tracker_action is not None:
        x = x + F.linear(F.one_hot(tracker_action, actions).float(),
                         p[f"{pre}.fc_action_tracker.weight"],
                         p[f"{pre}.fc_action_tracker.bias"])
    gates = (x @ p[f"{pre}.lstm.weight_ih"].t() + p[f"{pre}.lstm.bias_ih"]
             + h @ p[f"{pre}.lstm.weight_hh"].t() + p[f"{pre}.lstm.bias_hh"])
    i, f, g, o = gates.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    value = F.linear(h, p[f"{pre}.value.weight"], p[f"{pre}.value.bias"])
    logits = F.linear(h, p[f"{pre}.policy.weight"], p[f"{pre}.policy.bias"])
    r_pred = None
    if tracker_action is not None:
        r_pred = F.linear(h, p[f"{pre}.reward_aux.weight"],
                          p[f"{pre}.reward_aux.bias"])
    return value, logits, h, c, r_pred


def sample(logits, gumbel):
    """Gumbel-max action, the softmax's entropy and the action's log p."""
    logp = torch.log_softmax(logits, -1)
    entropy = -(logp * torch.exp(logp)).sum(-1)
    action = torch.argmax(logits.detach() + gumbel, -1)
    return action, entropy, logp.gather(-1, action[:, None])[:, 0]


def both(p, tat: bool, obs, hx, cx, noise):
    """The tracker acts, then the target (a TAT target on both frames and
    the tracker's action)."""
    v0, l0, h0, c0, _ = player(p, "player0", obs[:, 0], hx[:, 0], cx[:, 0])
    a0, e0, lp0 = sample(l0, noise[:, 0])
    if tat:
        v1, l1, h1, c1, r_pred = player(
            p, "player1", torch.cat([obs[:, 0], obs[:, 1]], 1), hx[:, 1],
            cx[:, 1], a0)
    else:
        v1, l1, h1, c1, r_pred = player(p, "player1", obs[:, 1], hx[:, 1],
                                        cx[:, 1])
    a1, e1, lp1 = sample(l1, noise[:, 1])
    return (torch.cat([v0, v1], -1), torch.stack([a0, a1], 1),
            torch.stack([e0, e1], 1), torch.stack([lp0, lp1], 1),
            torch.stack([h0, h1], 1), torch.stack([c0, c1], 1), r_pred)


def gae(rewards, values, bootstrap, done, gamma: float, tau: float):
    cont = (1.0 - done.float())[..., None]
    v_next = torch.cat([values[1:], bootstrap[None]], 0)
    r_acc, g_acc = bootstrap, torch.zeros_like(bootstrap)
    ret, adv = [], []
    for t in reversed(range(rewards.shape[0])):
        r_acc = gamma * r_acc * cont[t] + rewards[t]
        delta = rewards[t] + gamma * v_next[t] * cont[t] - values[t]
        g_acc = g_acc * gamma * tau * cont[t] + delta
        ret.append(r_acc)
        adv.append(g_acc)
    return torch.stack(ret[::-1]), torch.stack(adv[::-1])


class Adam:
    """SharedAdam: the gradients clipped together at global norm `clip`,
    then m, v, max v, and p -= lr sqrt(1 - b2^t) / (1 - b1^t) m /
    (sqrt(max v) + eps)."""

    def __init__(self, names: List[str], lr=1e-3, betas=(0.9, 0.999),
                 eps=1e-3, clip=50.0):
        self.names, self.lr, self.betas, self.eps = names, lr, betas, eps
        self.clip, self.t, self.state = clip, 0, {}

    @torch.no_grad()
    def step(self, params, grads) -> Dict[str, torch.Tensor]:
        """Updates `params` in place; returns the clipped gradients."""
        gs = [grads[n] if grads.get(n) is not None
              else torch.zeros_like(params[n]) for n in self.names]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in gs))
        gs = [torch.where(norm < self.clip, g, g / norm * self.clip)
              for g in gs]
        self.t += 1
        b1, b2 = self.betas
        t = torch.tensor(float(self.t))
        size = float(self.lr * torch.sqrt(1 - b2 ** t) / (1 - b1 ** t))
        for n, g in zip(self.names, gs):
            if n not in self.state:
                self.state[n] = [torch.zeros_like(g) for _ in range(3)]
            m, v, vmax = self.state[n]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g * g))
            torch.maximum(vmax, v, out=vmax)
            params[n].add_(-size * m / (torch.sqrt(vmax) + self.eps))
        return dict(zip(self.names, gs))


def run_reference(cfg: dict, traffic: dict, seed: int, steps: int = 3,
                  device="cpu", pool_seed_offset: int = 777) -> dict:
    """The first `steps` iterations of a cell from `seed`.

    `cfg` is the configuration file's object, `traffic` the mix's. Returns
    {"losses": [...], "grads": {name: first clipped gradient},
    "change": {name: parameter after the steps less before}}, on the CPU.
    """
    env = track2d.Env(target=cfg["target_mode"], device=device,
                      max_steps=cfg["max_episode_steps"],
                      tape_len=cfg["tape_len"],
                      goal_candidates=cfg["nav_goal_candidates"],
                      flood_cap=cfg["flood_iters"])
    tat, actions = cfg["tat"], cfg["num_actions"]
    n, T = traffic["num_envs"], traffic["num_steps"]
    pool_n, k_refresh = traffic["reset_pool"], traffic["pool_refresh"]
    mode = cfg["train_mode"]
    gamma, tau = cfg["gamma"], cfg["tau"]
    w_ent = torch.tensor([cfg["entropy"], cfg["entropy_target"]],
                         device=device)
    obs_side = 2 * env.pob + 1

    gen = tf.Generator(seed, device)
    params = {}
    params.update(init_player("player0", 1, obs_side, actions, False, gen,
                              device))
    params.update(init_player("player1", 2 if tat else 1, obs_side, actions,
                              tat, gen, device))
    start = {k: v.clone() for k, v in params.items()}
    trained = [k for k in params if mode not in (0, 1)
               or k.startswith(f"player{mode}.")]
    opt = Adam(trained, lr=cfg["lr"], eps=cfg["adam_eps"],
               clip=cfg["grad_clip"])
    state, obs = track2d.reset_chunked(env, n, gen)
    stack = obs[:, :, None]
    hx = torch.zeros((n, 2, HIDDEN), device=device)
    cx = torch.zeros_like(hx)
    losses, first_grads = [], None
    pool = ptr = None
    for it in range(steps):
        noise = tf.gumbel((T, n, 2, actions), gen)
        boot_noise = tf.gumbel((n, actions), gen)
        if k_refresh == 1:
            pool = track2d.reset_rows(env, pool_n, gen)
            ptr = torch.zeros((), dtype=torch.int64, device=device)
        elif it % k_refresh == 0:
            # the trainer's pool generator: seed + 777 folded with the
            # iteration (counted from 1) that opens the period
            pool_gen = tf.Generator(seed + pool_seed_offset,
                                    device).fold_in(it + 1)
            pool = track2d.reset_rows(env, pool_n, pool_gen)
            ptr = torch.zeros((), dtype=torch.int64, device=device)
        for v in params.values():
            v.requires_grad_(True)
            v.grad = None
        outs, r_preds = [], []
        h, c = hx, cx
        for t in range(T):
            values, acts, ent, logp, h, c, r_pred = both(
                params, tat, stack.float(), h, c, noise[t])
            r_preds.append(r_pred)
            state, o, rewards, done = track2d.step(env, state, acts)
            state, o2, ptr = track2d.autoreset(state, o, done, pool[0],
                                               pool[1], ptr)
            stack = o2[:, :, None]        # one frame: the newest
            zero = done[:, None, None]
            h = torch.where(zero, 0.0, h)
            c = torch.where(zero, 0.0, c)
            outs.append((values, logp, ent, rewards, done))
        values, logp, ent, rewards, done = (torch.stack(x) for x in zip(*outs))
        with torch.no_grad():
            obs_f = stack.float()
            v0, l0, _, _, _ = player(params, "player0", obs_f[:, 0], h[:, 0],
                                     c[:, 0])
            a0 = torch.argmax(l0 + boot_noise, -1)
            frames1 = (torch.cat([obs_f[:, 0], obs_f[:, 1]], 1) if tat
                       else obs_f[:, 1])
            v1, _, _, _, _ = player(params, "player1", frames1, h[:, 1],
                                    c[:, 1], a0 if tat else None)
            boot = torch.cat([v0, v1], -1)
        ret, adv = gae(rewards, values.detach(), boot, done, gamma, tau)
        value_loss = (0.5 * (ret - values) ** 2).sum(0)
        policy_loss = (-(logp * adv) - w_ent * ent).sum(0)
        per_player = policy_loss + 0.5 * value_loss
        if mode == 0:
            loss = per_player[:, 0]
        elif mode == 1:
            loss = per_player[:, 1]
        else:
            loss = per_player[:, 0] + per_player[:, 1]
        if tat and cfg["aux_reward"] and mode != 0:
            loss = loss + (torch.stack(r_preds)[..., 0]
                           - rewards[..., 0]).abs().sum(0)
        loss = loss.mean()
        loss.backward()
        grads = {k: v.grad for k, v in params.items()}
        for v in params.values():
            v.requires_grad_(False)
        clipped = opt.step(params, grads)
        if first_grads is None:
            first_grads = {k: clipped.get(k, torch.zeros_like(v)).cpu()
                           for k, v in params.items()}
        losses.append(loss.item())
        hx, cx = h.detach(), c.detach()
    return {"losses": losses, "grads": first_grads,
            "change": {k: (params[k] - start[k]).cpu() for k in params}}
