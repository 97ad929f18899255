"""Training CLI. Port of ``active_tracking_rl_tpu/run/train.py``.

One process drives the learner on one device: each iteration the
curriculum picks the loss's mode and one train step runs (rollout, loss,
backward, clipped optimizer step). Every `--checkpoint-every` iterations
and at the last, the greedy evaluator runs `--test-eps` episodes on
`--env-base`, and the checkpoint manager writes flax-format parameter files
and the exact-resume state ``train_state.pt``. The flags, their defaults
and the scalar names are the JAX CLI's, plus `--device`, `--no-split` and
`--dist-backend`.

With `--num-processes` W > 1 the run is data-parallel over
``torch.distributed`` (``parallel/mesh.py``), one process per device: rank
r holds rows [rB/W, (r+1)B/W) of the `--num-envs` B rows and block r of the
reset pool, the gradients are averaged over the ranks before the clipped
update, and the metrics are the global ones. W ranks compute what one
process computes with ``make_train_step(..., pool_blocks=W)``. Every rank
evaluates and tracks the best score; only rank 0 writes parameter files,
``train_state.pt`` (with the gathered carry and every rank's pool pointer)
and ``ckpt_meta.json``; rank r > 0 logs to the run dir suffixed ``-r{r}``.
A resume needs the same W. Two ranks on the CPU:

    python -m active_tracking_rl_torch.run.train --device cpu \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id R ...

(one command per rank R); on N cards use `--device cuda` (rank r drives
``cuda:r``, over nccl). Several ranks on one card need `--dist-backend
gloo`.

AD-VAT (the default config) on the card:

    python -m active_tracking_rl_torch.run.train --num-envs 4096 \\
        --reset-pool 512 --total-iters 2000

A tiny run on the CPU:

    python -m active_tracking_rl_torch.run.train --device cpu \\
        --env Track2D-BlockPartialRam-v0 --env-base Track2D-BlockPartialRam-v0 \\
        --num-envs 16 --reset-pool 8 --num-steps 8 --test-eps 8 \\
        --total-iters 4 --checkpoint-every 2 --log-dir /tmp/logs

Then `--resume <run dir>` continues that run exactly; `--load-model-dir
<all-best.msgpack>` warm-starts the parameters only.

The pool generator of `--pool-refresh` K > 1 and the eval generator are
keyed by seed + 777 and seed + 999 folded with the iteration
(``noise.Threefry.fold_in``), so their
draws depend only on the iteration, and the pool is refreshed at
iterations 1, K + 1, 2K + 1, ...; the carry's generator state, the pool
pointer and the rest of ``train_state.pt`` make the resumed run equal the
uninterrupted one bit for bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from datetime import datetime
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from active_tracking_rl_torch.config import (NetConfig, TrainConfig,
                                             net_config_for, parse_env_id)
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.envs.types import EnvState
from active_tracking_rl_torch.models.dueling import (build_model,
                                                     params_to_flax)
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.parallel.mesh import (Mesh, MeshSpec,
                                                    host_init, make_mesh,
                                                    shutdown)
from active_tracking_rl_torch.rl import curriculum
from active_tracking_rl_torch.rl.checkpoint import (CheckpointManager,
                                                    load_params,
                                                    load_train_state)
from active_tracking_rl_torch.rl.evaluate import make_evaluator
from active_tracking_rl_torch.rl.learner import (init_learner, init_pool_ptr,
                                                 make_pool_fn, make_train_step)
from active_tracking_rl_torch.rl.rollout import TrainCarry
from active_tracking_rl_torch.utils.logging import (MetricWriter, close_logger,
                                                    setup_logger)
from active_tracking_rl_torch.utils.platform import (default_backend,
                                                     pin_float32,
                                                     resolve_device)

#: offsets of the per-iteration pool and eval generators' seeds
POOL_SEED, EVAL_SEED = 777, 999


def build_argparser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, names and defaults, plus --device and the
    --no-split negation."""
    p = argparse.ArgumentParser(description="AD-VAT trainer (PyTorch)")
    p.add_argument("--env", default="Track2D-BlockPartialPZR-v0")
    p.add_argument("--env-base", default="Track2D-BlockPartialNav-v0")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--tau", type=float, default=1.0)
    p.add_argument("--entropy", type=float, default=0.01)
    p.add_argument("--entropy-target", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--test-eps", type=int, default=100)
    p.add_argument("--optimizer", default="Adam", help="Adam or RMSprop")
    p.add_argument("--network", default=None,
                   help="{tat-}?{cnn|icml|maze}{-lstm|-gru}? (default: "
                        "tat-maze-lstm for dueling PZR/Far, else maze-lstm)")
    p.add_argument("--aux", default="reward")
    p.add_argument("--train-mode", type=int, default=-1)
    p.add_argument("--init-step", type=int, default=-1)
    p.add_argument("--adv-step", type=int, default=500)
    p.add_argument("--stack-frames", type=int, default=1)
    p.add_argument("--rnn-out", type=int, default=128)
    p.add_argument("--max-step", type=int, default=150000)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--reset-pool", type=int, default=256)
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--load-model-dir", default=None,
                   help="a full parameter file (all-*.msgpack) to start from")
    p.add_argument("--split", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="also write tracker-*/target-* parameter files")
    p.add_argument("--checkpoint-every", type=int, default=200)
    p.add_argument("--total-iters", type=int, default=None,
                   help="stop after this many learner iterations "
                        "(default: --max-step)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of iterations 10-15 "
                        "here (trace.json, for chrome://tracing or Perfetto)")
    p.add_argument("--resume", default=None,
                   help="run dir to resume exactly: params, optimizer state, "
                        "iteration, env carry with its generator state, pool "
                        "pointer, curriculum and best-score watermark")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv and matmul inputs in the model "
                        "(parameters and heads stay float32)")
    p.add_argument("--center-full-obs", action="store_true",
                   help="Full-obs training aid (not reference behaviour): "
                        "roll each agent's full map so it sits at the centre; "
                        "applied to the training and the eval env")
    p.add_argument("--no-remat", action="store_true",
                   help="keep each rollout step's activations for the "
                        "backward pass instead of recomputing them (remat is "
                        "on by default; the gradients are the same)")
    p.add_argument("--pool-refresh", type=int, default=1,
                   help="regenerate the reset pool every K iterations "
                        "outside the train step; K=1 (default) generates a "
                        "fresh pool inside every step")
    p.add_argument("--debug-nans", action="store_true",
                   help="check every iteration's metrics for NaN/Inf and "
                        "abort naming the fields")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0, where the ranks of a "
                        "multi-process run meet (torch.distributed)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="data-parallel ranks, one process per device; "
                        "--num-envs and --reset-pool split over them")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's rank, 0 .. --num-processes - 1")
    p.add_argument("--local-devices", type=int, default=None,
                   help="only 1: torch has no virtual devices, so run one "
                        "process per device")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend (default nccl on cuda, "
                        "gloo on cpu). NCCL takes one card per rank: two "
                        "ranks on one card fail with its 'Duplicate GPU "
                        "detected' error; use gloo to run several ranks on "
                        "one card")
    p.add_argument("--run-name", default=None,
                   help="fixed run-dir name instead of the timestamp")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for small runs)")
    return p


def metrics_to_host(m) -> Dict[str, np.ndarray]:
    return {f: v.detach().cpu().numpy() for f, v in zip(m._fields, m)}


def check_finite_metrics(m, it: int) -> None:
    """--debug-nans: raise FloatingPointError naming every non-finite field
    of `m`, a TrainMetrics of tensors."""
    bad = {f: v for f, v in metrics_to_host(m).items()
           if not np.all(np.isfinite(v))}
    if bad:
        raise FloatingPointError(
            f"non-finite training metrics at iter {it}: {bad} (run under "
            "torch.autograd.set_detect_anomaly(True) to find the op)")


def train_config_from_args(args) -> TrainConfig:
    return TrainConfig(
        env_id=args.env, env_base=args.env_base, lr=args.lr,
        gamma=args.gamma, tau=args.tau, entropy=args.entropy,
        entropy_target=args.entropy_target, seed=args.seed,
        num_steps=args.num_steps, max_step=args.max_step,
        test_eps=args.test_eps, optimizer=args.optimizer,
        train_mode=args.train_mode, init_step=args.init_step,
        adv_step=args.adv_step, num_envs=args.num_envs,
        reset_pool=args.reset_pool, split=args.split,
        log_dir=args.log_dir, checkpoint_every=args.checkpoint_every,
        bf16=args.bf16, remat=not args.no_remat)


def net_config_from_args(args, tcfg: TrainConfig) -> NetConfig:
    if args.network:
        ncfg = NetConfig.from_name(args.network, rnn_out=args.rnn_out,
                                   stack_frames=args.stack_frames,
                                   aux=args.aux)
    else:
        ncfg = net_config_for(tcfg)
    return dataclasses.replace(ncfg, bf16=tcfg.bf16)


def iteration_generator(base_seed: int, it: int, device) -> noise.Threefry:
    """A generator whose draws depend only on (base_seed, it): the key of
    base_seed folded with it."""
    return noise.generator(base_seed, device).fold_in(it)


def carry_state(carry: TrainCarry, mesh: Mesh = Mesh()) -> Dict[str, Any]:
    """The carry as a dict of tensors (train_state.pt's "carry"); over
    several ranks, every rank's rows gathered in rank order (a collective:
    every rank calls it). The generator is in one state on every rank."""
    gather = mesh.gather_rows
    return {"env_state": {f.name: gather(getattr(carry.env_state, f.name))
                          for f in dataclasses.fields(EnvState)},
            "obs_stack": gather(carry.obs_stack), "hx": gather(carry.hx),
            "cx": gather(carry.cx),
            "generator": carry.generator.get_state()}


def restore_carry(saved: Dict[str, Any], generator: noise.Threefry,
                  rows: Optional[Tuple[int, int]] = None) -> TrainCarry:
    """The carry of `carry_state`, its rows lo..hi-1 if `rows` is given;
    `generator` takes its saved state (a CPU byte tensor, whatever device
    the rest was loaded to)."""
    generator.set_state(saved["generator"].cpu())
    lo, hi = rows if rows is not None else (None, None)
    return TrainCarry(
        EnvState(**{k: v[lo:hi] for k, v in saved["env_state"].items()}),
        saved["obs_stack"][lo:hi], saved["hx"][lo:hi], saved["cx"][lo:hi],
        generator)


@dataclasses.dataclass
class Session:
    """A trainer set up by `setup`, ready to `run`."""

    args: argparse.Namespace
    tcfg: TrainConfig
    ncfg: NetConfig
    device: torch.device
    run_dir: str
    log: Any
    env: TrackEnv
    env_base: TrackEnv
    model: torch.nn.Module
    opt: torch.optim.Optimizer
    carry: TrainCarry
    cur: curriculum.CurriculumState
    ckpt: CheckpointManager
    #: the data-parallel mesh; Mesh() for one process
    mesh: Mesh = Mesh()
    start_iter: int = 0
    #: the autoreset pointer of a pool refreshed every K > 1 iterations
    pool_ptr: Optional[torch.Tensor] = None
    #: what the last run's iterations logged (host numbers)
    last_metrics: Optional[Dict[str, np.ndarray]] = None


def setup(argv=None) -> Session:
    """Parse `argv`, build env, model, optimizer and carry, and restore a
    resumed run's state."""
    args = build_argparser().parse_args(argv)
    pin_float32()
    if args.local_devices not in (None, 1):
        raise ValueError(f"--local-devices {args.local_devices}: torch has "
                         f"no virtual devices; run one process per device "
                         f"(--num-processes)")
    tcfg = train_config_from_args(args)
    ncfg = net_config_from_args(args, tcfg)
    world = args.num_processes
    if tcfg.num_envs % world or tcfg.reset_pool % world:
        raise ValueError(
            f"--num-envs ({tcfg.num_envs}) and --reset-pool "
            f"({tcfg.reset_pool}) must be divisible by the dp mesh size "
            f"{world}")
    device = resolve_device(args.device, args.process_id)
    if world == 1 and args.coordinator:
        raise ValueError("--coordinator needs --num-processes > 1")
    host_init(args.coordinator, world, args.process_id,
              args.dist_backend or default_backend(device), device)
    mesh = make_mesh(MeshSpec())
    try:
        run_name = args.run_name or datetime.now().strftime("%b%d_%H-%M")
        if not mesh.is_lead:
            run_name += f"-r{mesh.rank}"
        run_dir = os.path.join(tcfg.log_dir, tcfg.env_id, run_name)
        log = setup_logger(f"{tcfg.env_id}_log",
                           os.path.join(run_dir, "logger"))
    except BaseException:
        shutdown()
        raise
    for k, v in vars(args).items():
        log.info(f"{k}: {v}")

    try:
        return _build(args, tcfg, ncfg, device, run_dir, log, mesh)
    except BaseException:
        close_logger(log)
        shutdown()
        raise


def _build(args, tcfg: TrainConfig, ncfg: NetConfig, device: torch.device,
           run_dir: str, log, mesh: Mesh) -> Session:
    ecfg = parse_env_id(tcfg.env_id)
    base_cfg = parse_env_id(tcfg.env_base)
    if args.center_full_obs:
        ecfg = dataclasses.replace(ecfg, center_full_obs=True)
        base_cfg = dataclasses.replace(base_cfg, center_full_obs=True)
    env = TrackEnv(ecfg, device)
    env_base = TrackEnv(base_cfg, device)
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, device=device)
    generator = noise.generator(tcfg.seed, device)
    state = init_learner(model, env, ncfg, tcfg, generator, mesh)
    if args.load_model_dir:
        load_params(model, args.load_model_dir)
    session = Session(args, tcfg, ncfg, device, run_dir, log, env, env_base,
                      model, state.opt, state.carry,
                      curriculum.CurriculumState.initial(tcfg),
                      CheckpointManager(run_dir, split=tcfg.split), mesh)
    if args.resume:
        saved = load_train_state(args.resume, map_location=device)
        if saved.get("world", 1) != mesh.world:
            raise ValueError(f"{args.resume} was saved by "
                             f"{saved.get('world', 1)} processes; resume it "
                             f"with as many (--num-processes)")
        model.load_state_dict(saved["model"])
        session.opt.load_state_dict(saved["optimizer"])
        session.carry = restore_carry(saved["carry"], generator,
                                      mesh.rows(tcfg.num_envs))
        session.cur = curriculum.CurriculumState(**saved["curriculum"])
        session.ckpt.max_score = float(saved["max_score"])
        session.start_iter = int(saved["step"])
        ptr = saved["pool_ptr"]
        session.pool_ptr = None if ptr is None else ptr[mesh.rank]
        log.info(f"resumed from {args.resume} at iter {session.start_iter}")
    return session


def run(s: Session) -> Session:
    """Iterations start_iter + 1 .. total; returns the session at the end."""
    args, tcfg = s.args, s.tcfg
    refresh = args.pool_refresh
    train_step = make_train_step(s.model, s.env, s.ncfg, tcfg, s.opt,
                                 mesh=s.mesh)
    pool_fn = make_pool_fn(s.env, tcfg, s.mesh)
    evaluator = make_evaluator(s.model, s.env_base, s.ncfg, tcfg.test_eps)
    writer = MetricWriter(s.run_dir)
    profiler = None
    pool = None
    total = args.total_iters or tcfg.max_step
    env_steps_per_iter = tcfg.num_envs * tcfg.num_steps
    t_last = time.time()
    try:
        for it in range(s.start_iter + 1, total + 1):
            if args.profile_dir and it == s.start_iter + 10:
                profiler = _start_profiler(s.device)
            if profiler is not None and it == s.start_iter + 15:
                _stop_profiler(profiler, args.profile_dir, s.device,
                               s.mesh.rank)
                profiler = None
                s.log.info(f"profiler trace written to {args.profile_dir}")
            s.cur = curriculum.update(tcfg, s.cur, it)
            if refresh > 1:
                if pool is None or (it - 1) % refresh == 0:
                    window = it - (it - 1) % refresh
                    pool = pool_fn(iteration_generator(
                        tcfg.seed + POOL_SEED, window, s.device))
                    if (it - 1) % refresh == 0 or s.pool_ptr is None:
                        s.pool_ptr = init_pool_ptr(device=s.device)
                s.carry, m, s.pool_ptr = train_step(s.carry, s.cur.mode,
                                                    (*pool, s.pool_ptr))
            else:
                s.carry, m, _ = train_step(s.carry, s.cur.mode)
            if args.debug_nans:
                check_finite_metrics(m, it)
            if it % 50 == 0 or it == 1:
                h = s.last_metrics = metrics_to_host(m)
                dt = time.time() - t_last
                fps = (50 if it > 1 else 1) * env_steps_per_iter / dt
                t_last = time.time()
                writer.write(it, {
                    "train/policy_loss_0": h["policy_loss"][0],
                    "train/policy_loss_1": h["policy_loss"][1],
                    "train/value_loss_0": h["value_loss"][0],
                    "train/value_loss_1": h["value_loss"][1],
                    "train/entropies0": h["entropy"][0],
                    "train/entropies1": h["entropy"][1],
                    "train/pred_R_loss": h["pred_loss"],
                    "train/reward_0": h["ep_return"][0],
                    "train/reward_1": h["ep_return"][1],
                    "train/eps_len": h["ep_len"],
                    "train/mode": s.cur.mode,
                    "train/fps": fps,
                    "train/grad_norm": h["grad_norm"],
                })
                s.log.info(f"iter {it} mode {s.cur.mode} loss "
                           f"{float(h['loss']):.3f} R0 "
                           f"{float(h['ep_return'][0]):.1f} len "
                           f"{float(h['ep_len']):.0f} env-steps/s {fps:.0f}")
            if it % tcfg.checkpoint_every == 0 or it == total:
                _evaluate_and_save(s, evaluator, writer, it)
    finally:
        if profiler is not None:
            profiler.stop()
        writer.close()
    return s


def _evaluate_and_save(s: Session, evaluator, writer: MetricWriter,
                       it: int) -> None:
    """Every rank evaluates (same parameters, same seed) and tracks the
    best-score watermark; only the lead writes files."""
    t0 = time.time()
    mesh = s.mesh
    lead = mesh.is_lead
    ev = evaluator(iteration_generator(s.tcfg.seed + EVAL_SEED, it, s.device))
    if lead:
        writer.write(it, {
            "test/reward0": ev["R_mean"][0],
            "test/reward1": ev["R_mean"][1],
            "test/eps_len": ev["EL_mean"],
            "test/success_rate": ev["S_rate"],
        })
    seconds = time.time() - t0
    # gathering the carry and the pool pointers is a collective: every rank
    carry = carry_state(s.carry, mesh)
    pool_ptr = s.pool_ptr
    if pool_ptr is not None:
        pool_ptr = mesh.gather_rows(pool_ptr.reshape(1))
    score = float(ev["R_mean"][0])
    if lead:
        state_blob = {"model": s.model.state_dict(),
                      "optimizer": s.opt.state_dict(),
                      "carry": carry,
                      "curriculum": dataclasses.asdict(s.cur),
                      "step": it,
                      "pool_ptr": pool_ptr,
                      "world": mesh.world}
        best = s.ckpt.save(params_to_flax(s.model.state_dict(), s.ncfg),
                           state_blob, score, it)
    else:
        best = score >= s.ckpt.max_score
        s.ckpt.max_score = max(s.ckpt.max_score, score)
    s.log.info(f"eval iter {it}: R {ev['R_mean'].round(2)} EL "
               f"{float(ev['EL_mean']):.1f} S {float(ev['S_rate']):.2f} "
               f"({seconds:.3f} s)" + (" [best]" if best else ""))


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str, device: torch.device,
                   rank: int) -> None:
    """Write the trace as trace.json (rank r > 0: trace-r{r}.json)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    name = "trace.json" if rank == 0 else f"trace-r{rank}.json"
    profiler.export_chrome_trace(os.path.join(profile_dir, name))


def main(argv=None) -> Session:
    s = setup(argv)
    try:
        return run(s)
    finally:
        close_logger(s.log)
        shutdown()


if __name__ == "__main__":
    main()
