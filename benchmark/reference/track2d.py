"""The Track2D gridworld, plain: Block maps at level 0, partial
observations, a scripted navigator (Nav) or a learned target (PZR).

Written from the env's rules (AD-VAT's 2D environment as the repository
states them): an 80 x 80 interior with a wall border, a share U * 0.15 of
it walled by a random permutation; the tracker on a uniform free cell, the
target on a free cell beside it, two distinct goals; the navigator walks a
shortest path to a goal from BFS distance fields and falls back to random
actions; each agent sees a 13 x 13 window, the other agent painted 2 + 2j;
the tracker's reward is max(1 - 2d/6, -1), the target's
max(-r0 - w_p max(d - 6, 0)/6, -1); an episode ends after 11 steps apart or
500 steps, and its row takes the next row of a reset pool.

The draws follow the order in which the program makes them, so that one
seed gives one episode here and there. Nothing here is imported from the
program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from benchmark.reference import threefry as tf

INF = 16000
NEG = -1e9
SPAWN_RETRIES = 8
NAV_RETRIES = 6
PLANB_LEN = 10
#: moves: up, down, left, right
DELTAS = ((-1, 0), (1, 0), (0, -1), (0, 1))


@dataclasses.dataclass(frozen=True)
class Env:
    """What a configuration fixes of the env."""

    target: str              # "Nav" (scripted) or "PZR" (learned)
    side: int = 82           # 80 + the wall border
    pob: int = 6             # the window's half side
    actions: int = 4
    max_steps: int = 500
    tape_len: int = 512
    goal_candidates: int = 16
    flood_cap: int = 256
    device: str = "cpu"

    @property
    def w_p(self) -> float:
        return 1.0 if self.target == "PZR" else 0.0

    @property
    def scripted(self) -> bool:
        return self.target == "Nav"


FIELDS = ("maze", "pos", "tape", "t", "c_far", "done", "c_reward",
          "c_collision", "dist")


def draws(env: Env, n: int, gen: tf.Generator) -> dict:
    """Every draw of n fresh episodes, in the program's order."""
    c = env.side ** 2
    interior = (env.side - 2) ** 2
    d = {"ratio": tf.uniform((n,), gen),
         "perm": tf.permutations(n, interior, gen),
         "tracker": tf.gumbel((n, c), gen),
         "goals": tf.gumbel((n, c), gen),
         "retry": tf.gumbel((n, SPAWN_RETRIES, c), gen),
         "target": tf.gumbel((n, c), gen)}
    if env.scripted:
        d["candidates"] = tf.gumbel((n, env.goal_candidates - 1, c), gen)
        d["planb"] = tf.randint(env.actions, (n, env.tape_len), gen)
    return d


def block_map(env: Env, ratio_u, perm) -> torch.Tensor:
    inner = env.side - 2
    count = torch.floor(0.15 * ratio_u * (inner * inner)).long()
    rank = torch.arange(inner * inner, device=perm.device)
    walls = (rank[None] < count[:, None]).to(torch.uint8)
    flat = torch.zeros_like(walls).scatter_(1, perm, walls)
    return F.pad(flat.reshape(-1, inner, inner), (1, 1, 1, 1), value=1)


def top_cells(g, mask, k: int) -> torch.Tensor:
    """k distinct cells of `mask`, largest Gumbel first -> (N, k, 2)."""
    s = mask.shape[-1]
    g = torch.where(mask.reshape(mask.shape[0], -1), g, NEG)
    picks = []
    for _ in range(k):
        i = torch.argmax(g, dim=-1)
        picks.append(i)
        g = g.scatter(1, i[:, None], float("-inf"))
    i = torch.stack(picks, 1)
    return torch.stack([i // s, i % s], -1).to(torch.int32)


def spawns(env: Env, maze, d):
    free = maze == 0
    tracker = top_cells(d["tracker"], free, 1)[:, 0]
    goals = top_cells(d["goals"], free, 2)
    for i in range(SPAWN_RETRIES):
        clash = (goals == tracker[:, None]).all(-1).any(-1)
        goals = torch.where(clash[:, None, None],
                            top_cells(d["retry"][:, i], free, 2), goals)
    # the target: a free cell in rows x-1..x and columns y-1..y
    s = env.side
    idx = torch.arange(s, device=maze.device)
    x, y = tracker[:, 0, None, None], tracker[:, 1, None, None]
    r, c = idx[None, :, None], idx[None, None, :]
    near = ((r >= (x - 1).clamp_min(0)) & (r < (x + 1).clamp_max(s - 1))
            & (c >= (y - 1).clamp_min(0)) & (c < (y + 1).clamp_max(s - 1))
            & free)
    own = (r == x) & (c == y)
    near = torch.where(near.flatten(1).any(1)[:, None, None], near, own)
    target = top_cells(d["target"], near, 1)[:, 0]
    return torch.stack([tracker, target], 1), goals


def bfs_fields(maze, goals, cap: int) -> torch.Tensor:
    """Shortest 4-connected path lengths from each goal, INF beyond `cap`
    steps and on walls: synchronous relaxation. (N,S,S) x (N,G,2) ->
    (N,G,S,S) int16."""
    wall = (maze != 0)[:, None]
    s = maze.shape[-1]
    idx = torch.arange(s, device=maze.device)
    seed = ((idx[:, None] == goals[..., 0, None, None])
            & (idx[None, :] == goals[..., 1, None, None]) & ~wall)
    d = torch.where(seed, 0, INF).to(torch.int16)
    for i in range(cap):
        p = F.pad(d, (1, 1, 1, 1), value=INF)
        best = torch.minimum(torch.minimum(p[..., :-2, 1:-1], p[..., 2:, 1:-1]),
                             torch.minimum(p[..., 1:-1, :-2], p[..., 1:-1, 2:]))
        nd = torch.where(wall, INF, torch.minimum(d, best + 1))
        if i % 16 == 15 and torch.equal(nd, d):
            break
        d = nd
    return d


def nav_tape(env: Env, maze, spawn, first_goal, d) -> torch.Tensor:
    """The navigator's actions for `tape_len` ticks: when its plan runs
    out it tries up to six goal candidates for one at path length >= 1 and
    walks the field down (the first of the least neighbours in action
    order), else takes ten random actions."""
    n, s = maze.shape[0], env.side
    g, na, dev = env.goal_candidates, env.actions, maze.device
    free = (maze == 0).reshape(n, 1, -1)
    flat = torch.argmax(d["candidates"] + torch.where(free, 0.0, NEG), -1)
    cands = torch.cat([first_goal[:, None].to(torch.int32),
                       torch.stack([flat // s, flat % s], -1).to(torch.int32)],
                      1)
    fields = bfs_fields(maze, cands, env.flood_cap)
    wall = maze != 0
    padded = F.pad(fields, (1, 1, 1, 1), value=INF)
    wpad = F.pad(wall, (1, 1, 1, 1), value=True)
    best = torch.full_like(fields, INF)
    greedy = torch.zeros_like(fields, dtype=torch.uint8)
    wbits = torch.zeros((n, s, s), dtype=torch.int32, device=dev)
    for a, (dr, dc) in enumerate(DELTAS[:na]):
        shifted = padded[:, :, 1 + dr:1 + dr + s, 1 + dc:1 + dc + s]
        take = shifted < best
        greedy = torch.where(take, a, greedy)
        best = torch.where(take, shifted, best)
        wbits |= wpad[:, 1 + dr:1 + dr + s,
                      1 + dc:1 + dc + s].to(torch.int32) << a
    dist_t = fields.reshape(n, g, s * s).transpose(1, 2)
    greedy_t = greedy.reshape(n, g, s * s).transpose(1, 2)
    wbits = wbits.reshape(n, s * s)
    rows = torch.arange(n, device=dev)
    tries = torch.arange(NAV_RETRIES, device=dev)
    move = torch.tensor(DELTAS[:na], dtype=torch.int64, device=dev)
    planb_actions = d["planb"].long()
    pos = spawn.long()
    ptr = torch.zeros(n, dtype=torch.int64, device=dev)
    field = torch.zeros_like(ptr)
    left = torch.zeros_like(ptr)
    planb = torch.zeros(n, dtype=torch.bool, device=dev)
    tape = torch.empty((n, env.tape_len), dtype=torch.int8, device=dev)
    for tick in range(env.tape_len):
        need = left <= 0
        cell = pos[:, 0] * s + pos[:, 1]
        idx = (ptr[:, None] + tries) % g
        dist = dist_t[rows, cell].gather(1, idx)
        ok = (dist >= 1) & (dist < INF)
        found = ok.any(1)
        first = torch.argmax(ok.to(torch.uint8), 1)
        sel = torch.where(found, first, NAV_RETRIES - 1)[:, None]
        ptr = torch.where(need, ptr + torch.where(found, first + 1,
                                                  NAV_RETRIES), ptr)
        field = torch.where(need, idx.gather(1, sel)[:, 0], field)
        left = torch.where(need, torch.where(found, dist.gather(1, sel)[:, 0]
                                             .long(), PLANB_LEN), left)
        planb = torch.where(need, ~found, planb)
        walk = greedy_t[rows, cell].gather(1, field[:, None])[:, 0].long()
        action = torch.where(planb, planb_actions[:, tick], walk)
        hit = ((wbits[rows, cell] >> action) & 1).bool()
        pos = torch.where(hit[:, None], pos, pos + move[action])
        left = left - 1
        tape[:, tick] = action
    return tape


def observe(env: Env, maze_padded, pos) -> torch.Tensor:
    """Each agent's (2p+1)^2 window: walls 1, the other agent 2 + 2j where
    it is inside, the observer's own cell 2 + 2i."""
    w, p = 2 * env.pob + 1, env.pob
    n, side = maze_padded.shape[0], maze_padded.shape[-1]
    ar = torch.arange(w, device=pos.device)
    pos = pos.long()
    r = pos[..., 0, None, None] + ar[:, None]
    c = pos[..., 1, None, None] + ar[None, :]
    flat = maze_padded.reshape(n, 1, side * side).expand(n, 2, side * side)
    crop = flat.gather(2, (r * side + c).reshape(n, 2, w * w))
    rel = pos.flip(1) - pos + p
    inside = ((rel >= 0) & (rel < w)).all(-1, keepdim=True)
    cell = (rel[..., 0] * w + rel[..., 1]).clamp(0, w * w - 1)[..., None]
    colour = torch.tensor([2, 4], dtype=torch.uint8, device=pos.device)
    other = torch.where(inside, colour.flip(0).expand(n, 2)[..., None],
                        crop.gather(2, cell))
    crop = crop.scatter(2, cell, other)
    crop[..., p * w + p] = colour
    return crop.reshape(n, 2, w, w)


def distance(pos) -> torch.Tensor:
    return torch.sqrt(((pos[:, 1] - pos[:, 0]).float() ** 2).sum(-1))


def reset(env: Env, d: dict):
    """Fresh episodes from their draws -> (state dict, obs)."""
    maze = block_map(env, d["ratio"], d["perm"])
    pos, goals = spawns(env, maze, d)
    n = maze.shape[0]
    if env.scripted:
        tape = nav_tape(env, maze, pos[:, 1], goals[:, 1], d)
    else:
        tape = torch.zeros((n, env.tape_len), dtype=torch.int8,
                           device=maze.device)
    p = env.pob
    padded = F.pad(maze, (p, p, p, p), value=1)
    zeros = torch.zeros(n, dtype=torch.int32, device=maze.device)
    state = dict(maze=padded, pos=pos, tape=tape, t=zeros, c_far=zeros.clone(),
                 done=torch.zeros(n, dtype=torch.bool, device=maze.device),
                 c_reward=torch.zeros((n, 2), device=maze.device),
                 c_collision=torch.zeros((n, 2), dtype=torch.int32,
                                         device=maze.device),
                 dist=distance(pos))
    return state, observe(env, padded, pos)


def reset_rows(env: Env, n: int, gen: tf.Generator):
    """n fresh episodes."""
    return reset(env, draws(env, n, gen))


def reset_chunked(env: Env, n: int, gen: tf.Generator, chunk_max: int = 4096):
    """n fresh episodes drawn in groups of at most chunk_max rows."""
    chunks = -(-n // chunk_max)
    size = -(-n // chunks)
    parts = []
    for c0 in range(0, n, size):
        parts.append(reset_rows(env, min(c0 + size, n) - c0, gen))
    states, obs = zip(*parts)
    return ({k: torch.cat([st[k] for st in states]) for k in FIELDS},
            torch.cat(obs))


def step(env: Env, state: dict, actions):
    """One move of both agents -> (state', obs, rewards (N,2), done)."""
    p = env.pob
    n = state["t"].shape[0]
    rows = torch.arange(n, device=actions.device)
    acts = actions.long()
    if env.scripted:
        t = state["t"].long().clamp_max(env.tape_len - 1)
        acts = torch.stack([acts[:, 0], state["tape"][rows, t].long()], 1)
    move = torch.tensor(DELTAS, dtype=torch.int32, device=actions.device)
    nxt = state["pos"] + move[acts]
    hit = state["maze"][rows[:, None], nxt[..., 0].long() + p,
                        nxt[..., 1].long() + p] == 1
    pos = torch.where(hit[..., None], state["pos"], nxt)
    d = distance(pos)
    f32 = dict(dtype=torch.float32, device=d.device)
    # each reward one float32 multiply-add, as the env rounds it
    r0 = torch.clamp_min(torch.addcmul(torch.tensor(1.0, **f32), d,
                                       torch.tensor(-2.0 / p, **f32)), -1.0)
    r1 = torch.clamp_min(torch.addcmul(-r0, torch.clamp_min(d - p, 0.0),
                                       torch.tensor(-env.w_p / p, **f32)),
                         -1.0)
    rewards = torch.stack([r0, r1], 1)
    c_far = torch.where(d <= p, 0, state["c_far"] + 1).to(torch.int32)
    t = state["t"] + 1
    done = (c_far > 10) | (t >= env.max_steps)
    new = dict(state, pos=pos, t=t, c_far=c_far, done=done,
               c_reward=state["c_reward"] + rewards,
               c_collision=state["c_collision"] + hit.to(torch.int32), dist=d)
    return new, observe(env, new["maze"], pos), rewards, done


def autoreset(state: dict, obs, done, pool: dict, pool_obs, ptr):
    """Done rows take the next pool rows, from the pool's pointer on."""
    r = pool["t"].shape[0]
    take = (ptr + torch.cumsum(done.long(), 0) - 1) % r
    ptr = (ptr + done.sum()) % r

    def pick(new, old):
        return torch.where(done.reshape((-1,) + (1,) * (old.dim() - 1)),
                           new[take], old)

    return ({k: pick(pool[k], state[k]) for k in FIELDS},
            pick(pool_obs, obs), ptr)
