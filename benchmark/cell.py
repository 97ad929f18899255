"""One process's part of a run: the program built from the seed, its first
steps read for the check, the timed window, the traced iterations, then
the reference.

The window drives ``rl/learner.py:make_train_step``'s step as
``run/train.py``'s iteration loop does: iterations counted from 1, a pool
from ``make_pool_fn`` and the generator of (seed + 777, iteration) at the
start of every period where the pool refresh K > 1, the step's own pool
where K = 1, the step's metrics read to the host every 50 iterations; no
evaluation, checkpoint or log file.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import tempfile
import time
from typing import Callable, List, Optional

import torch

from benchmark import check, faults, harness, trace as trace_mod
from benchmark.harness import CHECKED_STEPS

#: run/train.py's POOL_SEED: a K > 1 pool's generator is seeded seed + 777
POOL_SEED = 777
#: run/train.py's cadence of reading the step's metrics to the host
HOST_READ_EVERY = 50
#: traced iterations of a one-refresh (K = 1) mix; K > 1 traces K
TRACED_ITERS_K1 = 2


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ecfg_matches(cfg: dict, ecfg) -> None:
    """The env id gives what the configuration file states."""
    want = {"map_type": ecfg.map_type, "obs_type": ecfg.obs_type,
            "target_mode": ecfg.target_mode, "level": ecfg.level,
            "maze_size": ecfg.maze_size, "pob_window": ecfg.pob_window,
            "num_actions": ecfg.num_actions,
            "max_episode_steps": ecfg.max_episode_steps,
            "tape_len": ecfg.tape_len,
            "nav_goal_candidates": ecfg.nav_goal_candidates,
            "flood_iters": ecfg.flood_iters}
    bad = {k: (cfg[k], v) for k, v in want.items() if cfg[k] != v}
    if bad:
        raise ValueError(f"{cfg['env_id']} runs otherwise than its "
                         f"configuration states: {bad}")


@dataclasses.dataclass
class Trainer:
    """The program's learner as the trainer loop drives it."""

    env: object
    model: torch.nn.Module
    tcfg: object
    opt: torch.optim.Optimizer
    carry: object
    step: Callable
    pool_fn: Callable
    cur: object
    seed: int
    refresh: int
    device: torch.device
    pool: Optional[tuple] = None
    pool_ptr: Optional[torch.Tensor] = None
    host_metrics: Optional[dict] = None

    def iterate(self, it: int):
        """Iteration `it` (from 1); returns its metrics."""
        from active_tracking_rl_torch.ops import noise
        from active_tracking_rl_torch.rl import curriculum
        from active_tracking_rl_torch.rl.learner import init_pool_ptr
        self.cur = curriculum.update(self.tcfg, self.cur, it)
        if self.refresh > 1:
            if (it - 1) % self.refresh == 0:
                self.pool = self.pool_fn(noise.generator(
                    self.seed + POOL_SEED, self.device).fold_in(it))
                self.pool_ptr = init_pool_ptr(device=self.device)
            self.carry, m, self.pool_ptr = self.step(
                self.carry, self.cur.mode, (*self.pool, self.pool_ptr))
        else:
            self.carry, m, _ = self.step(self.carry, self.cur.mode)
        if it % HOST_READ_EVERY == 0 or it == 1:
            self.host_metrics = {f: v.detach().cpu() for f, v in
                                 zip(m._fields, m)}
        return m


def build(cfg: dict, traffic: dict, seed: int, device: torch.device,
          bf16: bool = False) -> Trainer:
    """The program's learner of the cell from `seed`, on `device`."""
    from active_tracking_rl_torch.config import (NetConfig, TrainConfig,
                                                 parse_env_id)
    from active_tracking_rl_torch.envs.env import TrackEnv
    from active_tracking_rl_torch.models.dueling import build_model
    from active_tracking_rl_torch.ops import noise
    from active_tracking_rl_torch.rl import curriculum
    from active_tracking_rl_torch.rl.learner import (init_learner,
                                                     make_pool_fn,
                                                     make_train_step)
    ecfg = parse_env_id(cfg["env_id"])
    _ecfg_matches(cfg, ecfg)
    tcfg = TrainConfig(
        env_id=cfg["env_id"], env_base=cfg["env_id"], lr=cfg["lr"],
        gamma=cfg["gamma"], tau=cfg["tau"], entropy=cfg["entropy"],
        entropy_target=cfg["entropy_target"], seed=seed,
        num_steps=traffic["num_steps"], optimizer=cfg["optimizer"],
        amsgrad=cfg["amsgrad"], train_mode=cfg["train_mode"],
        grad_clip=cfg["grad_clip"], num_envs=traffic["num_envs"],
        reset_pool=traffic["reset_pool"], remat=cfg["remat"])
    ncfg = NetConfig.from_name(cfg["network"], rnn_out=cfg["rnn_out"],
                               stack_frames=cfg["stack_frames"],
                               aux=cfg["aux"])
    ncfg = dataclasses.replace(ncfg, bf16=bf16)
    if (ncfg.encoder, ncfg.rnn, ncfg.tat, ncfg.aux_reward) != (
            cfg["encoder"], cfg["rnn"], cfg["tat"], cfg["aux_reward"]):
        raise ValueError(f"network {cfg['network']!r} is not the "
                         f"configuration's")
    env = TrackEnv(ecfg, device)
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape,
                        device=device)
    state = init_learner(model, env, ncfg, tcfg,
                         noise.generator(seed, device))
    if state.opt.param_groups[0].get("eps") != cfg["adam_eps"]:
        raise ValueError("the optimizer's eps is not the configuration's")
    step = make_train_step(model, env, ncfg, tcfg, state.opt)
    return Trainer(env, model, tcfg, state.opt, state.carry, step,
                   make_pool_fn(env, tcfg),
                   curriculum.CurriculumState.initial(tcfg), seed,
                   int(traffic["pool_refresh"]), device)


def first_steps(tr: Trainer, steps: int = CHECKED_STEPS) -> dict:
    """Iterations 1..steps, read for the check: each step's loss, the
    first gradient as the optimizer got it (Adam's first moment after one
    step over 1 - beta1), each parameter's change over the steps."""
    named = dict(tr.model.named_parameters())
    start = {k: v.detach().clone() for k, v in named.items()}
    beta1 = tr.opt.param_groups[0]["betas"][0]
    losses, grads = [], None
    for it in range(1, steps + 1):
        losses.append(tr.iterate(it).loss)
        if it == 1:
            grads = {}
            for k, p in named.items():
                st = tr.opt.state.get(p)
                grads[k] = ((st["exp_avg"] / (1 - beta1)).cpu() if st
                            else torch.zeros_like(p, device="cpu"))
    return {"losses": [float(x) for x in losses], "grads": grads,
            "change": {k: (v.detach() - start[k]).cpu()
                       for k, v in named.items()}}


def _runq_wait_s() -> Optional[float]:
    """Seconds this thread has waited for a core (Linux's schedstat)."""
    try:
        with open("/proc/thread-self/schedstat") as f:
            return int(f.read().split()[1]) / 1e9
    except (OSError, IndexError, ValueError):
        return None


def window(tr: Trainer, seconds: float, it: int,
           keep_going: Callable[[float], bool], barrier=lambda: None
           ) -> dict:
    """Iterations from `it` while `keep_going(seconds since the start)`;
    synchronised before the first and after the last. ``host`` says how
    the host spent the window: the driving thread's CPU seconds and its
    seconds waiting for a core."""
    sync(tr.device)
    barrier()
    sync(tr.device)
    losses: List[torch.Tensor] = []
    cpu0, wait0 = time.thread_time(), _runq_wait_s()
    t0 = time.perf_counter()
    while keep_going(time.perf_counter() - t0):
        losses.append(tr.iterate(it).loss)
        it += 1
    sync(tr.device)
    barrier()
    sync(tr.device)
    dt = time.perf_counter() - t0
    wait1 = _runq_wait_s()
    host = {"cpu_s": time.thread_time() - cpu0,
            "runq_wait_s": None if wait0 is None else wait1 - wait0}
    failed = (int((~torch.isfinite(torch.stack(losses))).sum())
              if losses else 0)
    return {"iters": len(losses), "seconds": dt, "next_it": it,
            "failed": failed, "host": host}


def _profile(tr: Trainer, it: int, n: int, acts, tmpdir: str) -> dict:
    """Trace iterations it..it+n-1 with profiler `acts` and reduce it."""
    sync(tr.device)
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(it, it + n):
            tr.iterate(i)
        sync(tr.device)
    path = os.path.join(tmpdir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        return trace_mod.load(path)
    finally:
        os.remove(path)


def traced(tr: Trainer, it: int, tmpdir: str) -> dict:
    """Trace whole refresh periods (K iterations from the start of one;
    two iterations where K = 1) twice: first the card's activity alone,
    whose busy time, kernels and launches the metrics read, then with the
    host's ops as well, which cost the host about as much again, for the
    breakdown's idle gaps named by the host's op. Returns the first trace
    reduced, with the second's idle gaps, the iteration count and the next
    iteration."""
    k = tr.refresh
    while k > 1 and (it - 1) % k:
        tr.iterate(it)
        it += 1
    n = k if k > 1 else TRACED_ITERS_K1
    cpu, cuda = (torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA)
    on_card = tr.device.type == "cuda"
    reduced = _profile(tr, it, n, [cuda] if on_card else [cpu], tmpdir)
    it += n
    host = _profile(tr, it, n, [cpu, cuda] if on_card else [cpu], tmpdir)
    reduced["idle_gaps"] = host["idle_gaps"]
    reduced["traced_iters"] = n
    reduced["next_it"] = it + n
    return reduced


def free(*objs) -> None:
    """Drop the program's state and give its memory back to the card."""
    del objs
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_numbers(cfg: dict, traffic: dict, seed: int, prog: dict,
                      device: torch.device) -> dict:
    """The reference's first steps from `seed`, compared with `prog`."""
    from benchmark.reference.learner import run_reference
    ref = run_reference(cfg, traffic, seed, CHECKED_STEPS, device,
                        POOL_SEED)
    return check.numbers(prog, ref)


def pin(device: torch.device) -> None:
    """What every entry point of the program sets: float32 without TF32,
    deterministic algorithms."""
    from active_tracking_rl_torch.utils.platform import (pin_deterministic,
                                                         pin_float32)
    pin_float32()
    pin_deterministic()
    if device.type == "cpu":
        torch.set_num_threads(1)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        variant: Optional[str], t_start: float) -> dict:
    """One cell in this process (one rank)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from active_tracking_rl_torch.utils.platform import resolve_device
        dev = resolve_device(device)
    pin(dev)
    t_build = time.perf_counter()
    tr = build(cell.cfg, cell.traffic, seed, dev, bf16=variant == "bf16")
    sync(dev)
    t_steps = time.perf_counter()
    undo = faults.plant(variant, tr)
    try:
        prog = first_steps(tr)
        sync(dev)
        setup_s = time.perf_counter() - t_start
        # set-up's parts: imports, the card's start and the learner built
        # from the seed, the checked steps
        parts = {"imports_s": t_build - t_start,
                 "build_s": t_steps - t_build,
                 "first_steps_s": t_start + setup_s - t_steps}
        win = window(tr, seconds, CHECKED_STEPS + 1,
                     lambda t: t < seconds)
        out = {"setup_s": setup_s, "iters": win["iters"],
               "window_s": win["seconds"], "failed": win["failed"]}
        rows = cell.traffic["num_envs"] * cell.traffic["num_steps"]
        out["rate"] = (win["iters"] * rows / win["seconds"]
                       if win["seconds"] > 0 else 0.0)
        red = None
        if trace:
            with tempfile.TemporaryDirectory() as tmp:
                red = traced(tr, win["next_it"], tmp)
            out.update(busy_s=red["busy_s"], trace_window_s=red["window_s"])
        if dev.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            out["device_name"] = torch.cuda.get_device_name(dev)
        else:
            out["memory_peak_bytes"] = 0
            out["device_name"] = "cpu"
        out["count"] = 1
        harness.measure(cell, out, red)
    finally:
        undo()
    free(tr)
    del tr
    free()
    nums = reference_numbers(cell.cfg, cell.traffic, seed, prog, dev)
    out["detail"] = {**nums.pop("_where"), "host": win["host"],
                     "setup": parts}
    out["numbers"] = nums
    return out
