"""Benchmark: env-steps/s on one card for the full training pipeline
(the batched Track2D rollout and the dueling A2C update; by default the
JAX bench's config: Track2D-BlockPartialNav-v0, maze-lstm tracker, train
mode 0, 4096 envs, 20 steps, a fresh reset pool every iteration, remat on).

Port of the repository's root ``bench.py`` (``run_bench`` and its CLI).
``run_bench`` builds the learner from seed 0, runs 2 untimed iterations,
then times `iters` iterations between two ``torch.cuda.synchronize()``
calls. With ``--pool-refresh`` K > 1 the timed window is rounded up to
whole refresh periods, and the step runs on an external pool
(``learner.make_pool_fn`` plus ``init_pool_ptr``) refreshed every K
iterations from a generator seeded by (7, iteration).

Prints ONE JSON line: bench.py's keys ``metric``, ``value``, ``unit`` and
``vs_baseline``, plus ``remat``, ``precision`` (``fp32``, or ``bf16``
model inputs under ``--bf16``; float32 never runs as TF32,
``utils/platform.py:pin_float32``) and ``device`` (the card's name).
``vs_baseline`` is null: ``BASELINE_MEASURED.json`` holds a CPU emulation
of the reference's worker loop measured for the JAX bench, no baseline of
this port. ``--measure-baseline`` is not ported: bench.py's
``measure_reference_emulation`` is already torch, and it writes that file
of the JAX bench. ``--sweep`` prints bench.py's dict of configs instead.

    python -m active_tracking_rl_torch.run.bench
    python -m active_tracking_rl_torch.run.bench --no-remat --iters 20
    python -m active_tracking_rl_torch.run.bench --device cpu \\
        --env Track2D-BlockPartialRam-v0 --num-envs 16 --iters 2

The device defaults to ``cuda``; asking for it where no card is visible
raises (``utils/platform.py:resolve_device``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import torch

from active_tracking_rl_torch.config import (NetConfig, TrainConfig,
                                             parse_env_id)
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import DuelingModel, build_model
from active_tracking_rl_torch.ops import flood
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.rl.learner import (init_learner, init_pool_ptr,
                                                 make_pool_fn, make_train_step)
from active_tracking_rl_torch.rl.rollout import TrainCarry
from active_tracking_rl_torch.run.train import iteration_generator
from active_tracking_rl_torch.utils.platform import (pin_deterministic,
                                                     pin_float32,
                                                     resolve_device, sync)

#: the seed of the external pool's generators, bench.py's PRNGKey(7)
POOL_SEED = 7


@dataclasses.dataclass
class Bench:
    """A built benchmark: the learner and its iteration function."""

    env: TrackEnv
    model: DuelingModel
    tcfg: TrainConfig
    ncfg: NetConfig
    device: torch.device
    pool_refresh: int
    #: the loss's train mode: train_mode, or -1 for any negative one
    mode: int
    #: the generator of init_learner, which the carry keeps
    generator: noise.Threefry
    #: step(carry, mode, pool=None) of learner.make_train_step
    train_step: Callable
    carry: TrainCarry
    #: the optimizer that train_step steps
    opt: torch.optim.Optimizer
    #: the external pool and its pointer (pool refresh K > 1)
    pool: Optional[tuple] = None
    pool_ptr: Optional[torch.Tensor] = None

    def iterate(self, it: int):
        """One iteration at index `it`; returns its metrics."""
        if self.pool_refresh > 1:
            if it % self.pool_refresh == 0:
                self.pool = make_pool_fn(self.env, self.tcfg)(
                    iteration_generator(POOL_SEED, it, self.device))
                self.pool_ptr = init_pool_ptr(device=self.device)
            self.carry, m, self.pool_ptr = self.train_step(
                self.carry, self.mode, (*self.pool, self.pool_ptr))
        else:
            self.carry, m, _ = self.train_step(self.carry, self.mode)
        return m


@dataclasses.dataclass
class BenchResult:
    env_steps_per_s: float
    #: the timed iterations and their seconds
    iters: int
    seconds: float
    losses: List[float]
    #: flood launches in the timed iterations
    launches: Dict[str, int]
    #: the card's peak allocated bytes over the timed iterations (0 on cpu)
    peak_bytes: int
    remat: bool
    precision: str
    device: str


def build_bench(num_envs: int = 4096, num_steps: int = 20,
                env_id: str = "Track2D-BlockPartialNav-v0",
                network: str = "maze-lstm", train_mode: int = 0,
                bf16: bool = False, pool_refresh: int = 1,
                remat: bool = True, device="cuda",
                flood_backend: Optional[str] = None) -> Bench:
    """The learner of bench.py's config on `device`; `flood_backend`
    overrides the env's (None keeps the id's)."""
    dev = resolve_device(device)
    tcfg = TrainConfig(env_id=env_id, num_envs=num_envs,
                       reset_pool=max(num_envs // 8, 64),
                       num_steps=num_steps, train_mode=train_mode,
                       remat=remat)
    aux = "reward" if "tat" in network else "none"
    ncfg = dataclasses.replace(NetConfig.from_name(network, aux=aux),
                               bf16=bf16)
    ecfg = parse_env_id(env_id)
    if flood_backend is not None:
        ecfg = dataclasses.replace(ecfg, flood_backend=flood_backend)
    env = TrackEnv(ecfg, dev)
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, device=dev)
    gen = noise.generator(0, dev)
    state = init_learner(model, env, ncfg, tcfg, gen)
    step = make_train_step(model, env, ncfg, tcfg, state.opt)
    return Bench(env, model, tcfg, ncfg, dev, pool_refresh,
                 train_mode if train_mode >= 0 else -1, gen, step,
                 state.carry, state.opt)


def time_bench(bench: Bench, iters: int, warmup: int = 2) -> BenchResult:
    """`warmup` untimed iterations, then `iters` timed ones (rounded up to
    whole refresh periods)."""
    k = bench.pool_refresh
    if k > 1 and iters % k:
        iters = (iters // k + 1) * k
    for i in range(warmup):
        bench.iterate(i % k)
    sync(bench.device)
    if bench.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(bench.device)
    before = flood.launches()
    losses = []
    t0 = time.perf_counter()
    for i in range(iters):
        losses.append(bench.iterate(i).loss)
    sync(bench.device)
    dt = time.perf_counter() - t0
    after = flood.launches()
    tcfg = bench.tcfg
    return BenchResult(
        env_steps_per_s=iters * tcfg.num_envs * tcfg.num_steps / dt,
        iters=iters, seconds=dt, losses=[x.item() for x in losses],
        launches={n: after[n] - before[n] for n in after},
        peak_bytes=(torch.cuda.max_memory_allocated(bench.device)
                    if bench.device.type == "cuda" else 0),
        remat=tcfg.remat, precision="bf16" if bench.ncfg.bf16 else "fp32",
        device=(torch.cuda.get_device_name(bench.device)
                if bench.device.type == "cuda" else str(bench.device)))


def run_bench(num_envs: int = 4096, num_steps: int = 20, iters: int = 10,
              env_id: str = "Track2D-BlockPartialNav-v0",
              network: str = "maze-lstm", train_mode: int = 0,
              bf16: bool = False, pool_refresh: int = 1,
              remat: bool = True, device="cuda") -> BenchResult:
    """bench.py's run_bench on `device`; its env-steps/s is the result's
    ``env_steps_per_s``."""
    bench = build_bench(num_envs, num_steps, env_id, network, train_mode,
                        bf16, pool_refresh, remat, device)
    return time_bench(bench, iters)


def sweep(device="cuda") -> Dict[str, float]:
    """bench.py's --sweep: env counts, refresh periods, bf16 and the
    AD-VAT config, by its keys."""
    def sps(**kw) -> float:
        return round(run_bench(device=device, **kw).env_steps_per_s, 1)

    out = {}
    for ne in (1024, 4096, 16384):
        out[f"nav_maze-lstm_n{ne}"] = sps(num_envs=ne)
    for k in (4, 16):
        out[f"nav_maze-lstm_n4096_poolK{k}"] = sps(num_envs=4096,
                                                    pool_refresh=k)
    out["nav_maze-lstm_n4096_bf16"] = sps(num_envs=4096, bf16=True)
    out["nav_maze-lstm_n4096_poolK16_bf16"] = sps(num_envs=4096,
                                                  pool_refresh=16, bf16=True)
    pzr = dict(num_envs=4096, env_id="Track2D-BlockPartialPZR-v0",
               network="tat-maze-lstm", train_mode=-1)
    out["pzr_tat-maze-lstm_n4096"] = sps(**pzr)
    out["pzr_tat-maze-lstm_n4096_bf16"] = sps(**pzr, bf16=True)
    return out


def result_line(res: BenchResult, env_id: str, pool_refresh: int) -> dict:
    """bench.py's line, plus what ran: remat, precision, device."""
    return {
        "metric": "env_steps_per_s_per_chip",
        "value": round(res.env_steps_per_s, 1),
        "unit": f"env-steps/s/chip ({env_id.rsplit('-', 1)[0]} train "
                f"pipeline, pool-refresh {pool_refresh})",
        "vs_baseline": None,
        "remat": res.remat,
        "precision": res.precision,
        "device": res.device,
    }


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="env-steps/s of the training "
                                "pipeline on one card")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--num-steps", type=int, default=20,
                   help="rollout length T (bench.py's run_bench argument)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--env", default="Track2D-BlockPartialNav-v0")
    p.add_argument("--network", default="maze-lstm")
    p.add_argument("--train-mode", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--no-remat", action="store_true",
                   help="keep each rollout step's activations instead of "
                        "recomputing them (remat is the default, as in "
                        "bench.py; the gradients are the same)")
    p.add_argument("--pool-refresh", type=int, default=1,
                   help="K=1 (default): a fresh reset pool inside every "
                        "step. K>1 regenerates it every K iterations "
                        "outside the step")
    p.add_argument("--sweep", action="store_true",
                   help="num_envs sweep + tat-PZR + bf16 configs; prints a "
                        "JSON dict instead of the one-line contract")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for small runs)")
    return p


def main(argv=None):
    """Prints the line (or the sweep's dict); returns the BenchResult (or
    the dict)."""
    args = build_argparser().parse_args(argv)
    pin_float32()
    pin_deterministic()
    if args.sweep:
        out = sweep(args.device)
        print(json.dumps(out, indent=1))
        return out
    res = run_bench(num_envs=args.num_envs, num_steps=args.num_steps,
                    iters=args.iters,
                    env_id=args.env, network=args.network,
                    train_mode=args.train_mode, bf16=args.bf16,
                    pool_refresh=args.pool_refresh,
                    remat=not args.no_remat, device=args.device)
    print(json.dumps(result_line(res, args.env, args.pool_refresh)),
          flush=True)
    return res


if __name__ == "__main__":
    main()
