"""Scripted targets compiled to per-episode action tapes, batched over rows.

Port of ``active_tracking_rl_tpu/envs/opponents.py``. At reset the scripted
target's whole episode is simulated, and per env step its action is then
``tape[t]``:

* Ram: the burst automaton, ``tape_len`` ticks;
* Nav and RPF: goal candidates (Nav: the reset goal and uniform free cells;
  RPF: the four patrol corners in turn), one BFS distance field per field
  goal (``distance_fields_backend`` with ``cfg.flood_backend``: a CUDA kernel
  on the card), then ``tape_len`` ticks of replan / greedy descent / planB;
* PZR, Far and Adv (learned targets): a zero tape.

Draws come in ``NavDraws`` and ``RamDraws``; ``draw_nav`` and ``draw_ram``
make them from a generator.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from active_tracking_rl_torch.config import EnvConfig
from active_tracking_rl_torch.envs.distance import INF, distance_fields_backend
from active_tracking_rl_torch.envs.maps import patrol_goals
from active_tracking_rl_torch.ops import noise

#: moves in the reference's action order: up/down/left/right, then the
#: four Moore diagonals.
DELTAS = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, 1), (1, 1), (-1, -1), (1, -1))

_RETRIES = 6     # initial goal + 5 resamples before planB
_PLANB_LEN = 10  # random actions in planB
#: candidate logit of a wall cell (free cells have 0).
_LOGIT_WALL = -1e9
_MAX_BURST = 9   # Ram burst lengths are uniform on 1..9


@dataclasses.dataclass
class NavDraws:
    #: (N, G-1, S*S) float32 Gumbel: goal candidates 1..G-1 (Nav only; RPF
    #: patrols fixed corners).
    candidates: Optional[torch.Tensor]
    planb: torch.Tensor        # (N, tape_len) int: planB random actions in [0, A)


@dataclasses.dataclass
class RamDraws:
    """The Ram automaton's draws; every integer is in [0, A) unless noted."""

    plan0: torch.Tensor        # (N, 9) int8: the first random burst
    len0: torch.Tensor         # (N,) int: its length, 1..9
    coin: torch.Tensor         # (N, tape_len) int: 0 = repeat-burst, 1 = random
    burst: torch.Tensor        # (N, tape_len) int8: the repeat-burst action
    length: torch.Tensor       # (N, tape_len) int: the next burst's length, 1..9
    plan: torch.Tensor         # (N, tape_len, 9) int8: the next random burst


def draw_nav(cfg: EnvConfig, n: int, generator: noise.Threefry, device,
             rows: Optional[Tuple[int, int]] = None) -> NavDraws:
    g = cfg.nav_goal_candidates
    candidates = None
    if cfg.target_mode == "Nav":
        candidates = noise.gumbel((n, g - 1, cfg.maze_size ** 2), generator,
                                  device, rows)
    return NavDraws(
        candidates=candidates,
        planb=noise.randint(cfg.num_actions, (n, cfg.tape_len), generator,
                            device, rows=rows))


def draw_ram(cfg: EnvConfig, n: int, generator: noise.Threefry, device,
             rows: Optional[Tuple[int, int]] = None) -> RamDraws:
    na, tl = cfg.num_actions, cfg.tape_len

    def ints(low, high, shape, dtype=torch.int64):
        return low + noise.randint(high - low, shape, generator, device,
                                   dtype, rows)

    return RamDraws(
        plan0=ints(0, na, (n, _MAX_BURST), torch.int8),
        len0=ints(1, _MAX_BURST + 1, (n,)),
        coin=ints(0, 2, (n, tl)),
        burst=ints(0, na, (n, tl), torch.int8),
        length=ints(1, _MAX_BURST + 1, (n, tl)),
        plan=ints(0, na, (n, tl, _MAX_BURST), torch.int8))


def ram_tape(cfg: EnvConfig, draws: RamDraws) -> torch.Tensor:
    """(N, tape_len) int8 tapes simulating the Ram agent's burst automaton.

    Each tick emits the current plan's next action. On emitting its last
    action it draws the next plan: with a coin of 0 a burst repeating one
    fresh action, which also REPLACES the action emitted this very tick (the
    reference overwrites `action` after drawing it); with 1 a random burst.
    """
    n = draws.len0.shape[0]
    rows = torch.arange(n, device=draws.len0.device)
    plan = draws.plan0
    plan_len = draws.len0.long()
    a_i = torch.zeros_like(plan_len)
    tape = torch.empty((n, cfg.tape_len), dtype=torch.int8,
                       device=plan.device)
    for tick in range(cfg.tape_len):
        coin = draws.coin[:, tick] == 0
        burst = draws.burst[:, tick]
        action = plan[rows, a_i]
        a_next = a_i + 1
        regen = a_next >= plan_len
        new_plan = torch.where(coin[:, None], burst[:, None],
                               draws.plan[:, tick])
        tape[:, tick] = torch.where(regen & coin, burst, action)
        plan = torch.where(regen[:, None], new_plan, plan)
        plan_len = torch.where(regen, draws.length[:, tick].long(), plan_len)
        a_i = torch.where(regen, 0, a_next)
    return tape


@functools.lru_cache(maxsize=None)
def deltas(device: torch.device) -> torch.Tensor:
    """(8, 2) int32 move table, made once per device (callers only read it)."""
    return torch.tensor(DELTAS, dtype=torch.int32, device=device)


def nav_candidates(cfg: EnvConfig, maze: torch.Tensor, first_goal: torch.Tensor,
                   cand_gumbel: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Goal candidates and their distance fields for N maps.

    Returns (candidates (N,G,2) int32, field_idx (G,) int32,
    fields (N,Gf,S,S) int16). Nav: candidate 0 is the reset goal, the rest
    uniform free cells (argmax of Gumbel noise over free cells), one field
    per candidate (Gf = G). RPF: the four patrol corners cycled from corner
    1, one field per corner (Gf = 4); `field_idx` maps candidate to field.
    """
    g = cfg.nav_goal_candidates
    n, s = maze.shape[0], maze.shape[-1]
    if cfg.target_mode == "RPF":
        patrol = patrol_goals(cfg, maze.device)
        field_idx = (1 + torch.arange(g, dtype=torch.int32,
                                      device=maze.device)) % 4
        candidates = patrol[field_idx.long()].expand(n, g, 2)
        fields = distance_fields_backend(maze, patrol.expand(n, 4, 2),
                                         cfg.flood_iters, cfg.flood_backend)
        return candidates, field_idx, fields
    free = (maze == 0).reshape(n, 1, -1)
    logits = torch.where(free, 0.0, _LOGIT_WALL)
    flat = torch.argmax(cand_gumbel + logits, dim=-1)
    rest = torch.stack([flat // s, flat % s], dim=-1).to(torch.int32)
    candidates = torch.cat([first_goal[:, None].to(torch.int32), rest], dim=1)
    field_idx = torch.arange(g, dtype=torch.int32, device=maze.device)
    fields = distance_fields_backend(maze, candidates, cfg.flood_iters,
                                     cfg.flood_backend)
    return candidates, field_idx, fields


def nav_tape(cfg: EnvConfig, maze: torch.Tensor, spawn: torch.Tensor,
             first_goal: torch.Tensor, draws: NavDraws) -> torch.Tensor:
    """(N, tape_len) int8 tapes simulating the reference Navigator.

    Per tick: when the plan is exhausted, replan: try up to 6 candidates for
    a reachable goal at path length >= 1, else fall back to 10 random actions
    (planB). Then act: greedy descent on the active field (first-min
    tie-break in action order) or the planB action; a move into a wall
    stays. Replans fire on plan exhaustion only, and candidates wrap modulo
    G, exactly as in the JAX package. RPF reads candidate i's field at
    (1 + i) % 4.
    """
    na = cfg.num_actions
    g = cfg.nav_goal_candidates
    dev = maze.device
    rpf = cfg.target_mode == "RPF"
    _, _, fields = nav_candidates(cfg, maze, first_goal, draws.candidates)
    n, gf, s, _ = fields.shape
    wall = maze != 0

    # Greedy action per (field, cell): strict `<` over the shifted neighbour
    # fields keeps the first minimum; bit a of wmask = wall at cell + DELTAS[a].
    padded = torch.nn.functional.pad(fields, (1, 1, 1, 1), value=INF)
    wpad = torch.nn.functional.pad(wall, (1, 1, 1, 1), value=True)
    best = torch.full_like(fields, INF)
    amap = torch.zeros_like(fields, dtype=torch.uint8)
    wmask = torch.zeros((n, s, s), dtype=torch.int32, device=dev)
    for a in range(na):
        dr, dc = DELTAS[a]
        shifted = padded[:, :, 1 + dr:1 + dr + s, 1 + dc:1 + dc + s]
        take = shifted < best
        amap = torch.where(take, a, amap)
        best = torch.where(take, shifted, best)
        wmask |= wpad[:, 1 + dr:1 + dr + s, 1 + dc:1 + dc + s].to(torch.int32) << a

    # cell-major tables: one row read per tick
    dist_t = fields.reshape(n, gf, s * s).transpose(1, 2).contiguous()
    amap_t = amap.reshape(n, gf, s * s).transpose(1, 2).contiguous()
    wbits_t = wmask.reshape(n, s * s)
    rows = torch.arange(n, device=dev)
    try_off = torch.arange(_RETRIES, device=dev)
    move = deltas(dev)[:na]
    planb_actions = draws.planb.to(torch.int64)

    pos = spawn.to(torch.int64)
    goal_ptr = torch.zeros(n, dtype=torch.int64, device=dev)
    cur_field = torch.zeros(n, dtype=torch.int64, device=dev)
    remaining = torch.zeros(n, dtype=torch.int64, device=dev)
    planb = torch.zeros(n, dtype=torch.bool, device=dev)
    tape = torch.empty((n, cfg.tape_len), dtype=torch.int8, device=dev)
    for tick in range(cfg.tape_len):
        need = remaining <= 0
        cell = pos[:, 0] * s + pos[:, 1]
        dists_all = dist_t[rows, cell]                    # (N, G) int16
        amap_row = amap_t[rows, cell]                     # (N, G)
        wbits = wbits_t[rows, cell]                       # (N,)

        # replan
        try_idx = (goal_ptr[:, None] + try_off) % g       # (N, 6)
        if rpf:
            try_idx = (1 + try_idx) % 4                   # candidate -> field
        dists = dists_all.gather(1, try_idx)
        ok = (dists >= 1) & (dists < INF)
        any_ok = ok.any(1)
        first = torch.argmax(ok.to(torch.uint8), dim=1)
        sel = torch.where(any_ok, first, _RETRIES - 1)[:, None]
        goal_ptr = torch.where(need, goal_ptr + torch.where(any_ok, first + 1,
                                                            _RETRIES), goal_ptr)
        cur_field = torch.where(need, try_idx.gather(1, sel)[:, 0], cur_field)
        r_remaining = torch.where(any_ok, dists.gather(1, sel)[:, 0].long(),
                                  _PLANB_LEN)
        remaining = torch.where(need, r_remaining, remaining)
        planb = torch.where(need, ~any_ok, planb)

        # act, then move (a wall stays)
        greedy = amap_row.gather(1, cur_field[:, None])[:, 0].long()
        action = torch.where(planb, planb_actions[:, tick], greedy)
        hit = ((wbits >> action) & 1).bool()
        pos = torch.where(hit[:, None], pos, pos + move[action])
        remaining = remaining - 1
        tape[:, tick] = action
    return tape


def build_tape(cfg: EnvConfig, maze: torch.Tensor, spawn: torch.Tensor,
               first_goal: torch.Tensor, nav: Optional[NavDraws],
               ram: Optional[RamDraws]) -> torch.Tensor:
    """The target mode's tape: Ram, Nav or RPF; zeros for the learned targets."""
    if cfg.target_mode == "Ram":
        return ram_tape(cfg, ram)
    if cfg.target_mode in ("Nav", "RPF"):
        return nav_tape(cfg, maze, spawn, first_goal, nav)
    return torch.zeros((maze.shape[0], cfg.tape_len), dtype=torch.int8,
                       device=maze.device)
