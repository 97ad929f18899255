"""Multi-process self-check: one rank of an N-process ``torch.distributed``
run.

Port of ``active_tracking_rl_tpu/parallel/mp_check.py``. Each rank builds
the same tiny learner (tat-maze-lstm on Track2D-EmptyPartialPZR-v0 with the
JAX check's reduced env: 8-step episodes, 4 goal candidates, 32 flood
iterations, 16-tick tapes), 2 envs and 1 pool row per rank, and runs
`--steps` data-parallel train steps of 4 env steps (the JAX check's 2 grown
to 4, so 3 steps cross the 8-step episode boundary) at train mode -1. It
prints ``MPCHECK rank=.. loss=.. digest=.. world=..``; the digest hashes the
bytes of every parameter, so equal digests on every rank show that the
gradient all-reduce and the replicated update ran as one program. W ranks
equal one process run with ``pool_blocks=W`` (:func:`run_check`).

Usage, one command per rank R:

    python -m active_tracking_rl_torch.parallel.mp_check \\
        --coordinator 127.0.0.1:PORT --num-processes 2 --process-id R \\
        --device cpu [--steps 3] [--out rank0.pt]

On the card (`--device cuda`) the backend defaults to nccl, one card per
rank; `--dist-backend gloo` runs several ranks on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import numpy as np
import torch

from active_tracking_rl_torch.config import (NetConfig, TrainConfig,
                                             parse_env_id)
from active_tracking_rl_torch.envs.env import TrackEnv
from active_tracking_rl_torch.models.dueling import build_model
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.parallel.mesh import (Mesh, MeshSpec,
                                                    host_init, make_mesh,
                                                    shutdown)
from active_tracking_rl_torch.rl.learner import init_learner, make_train_step
from active_tracking_rl_torch.utils.platform import (default_backend,
                                                     pin_deterministic,
                                                     pin_float32,
                                                     resolve_device)

ENV_ID = "Track2D-EmptyPartialPZR-v0"
ENVS_PER_RANK, POOL_PER_RANK, NUM_STEPS = 2, 1, 4
REDUCED_ENV = dict(max_episode_steps=8, nav_goal_candidates=4,
                   flood_iters=32, tape_len=16)


def run_check(world: int, device, steps: int = 3,
              mesh: Mesh = Mesh(), pool_blocks: int = 1, seed: int = 0):
    """`steps` train steps of the check's learner for `world` ranks' rows:
    this rank's over a mesh of `world` ranks, all of them in one process
    with ``Mesh()`` -> (model, carry, last metrics)."""
    tcfg = TrainConfig(env_id=ENV_ID, num_envs=ENVS_PER_RANK * world,
                       reset_pool=POOL_PER_RANK * world, num_steps=NUM_STEPS)
    ncfg = NetConfig.from_name("tat-maze-lstm")
    ecfg = dataclasses.replace(parse_env_id(ENV_ID), **REDUCED_ENV)
    env = TrackEnv(ecfg, device)
    model = build_model(ncfg, ecfg.num_actions, ecfg.obs_shape, device=device)
    gen = noise.generator(seed, device)
    state = init_learner(model, env, ncfg, tcfg, gen, mesh)
    step = make_train_step(model, env, ncfg, tcfg, state.opt, pool_blocks,
                           mesh)
    carry = state.carry
    for _ in range(steps):
        carry, metrics, _ = step(carry, -1)
    return model, carry, metrics


def digest(model: torch.nn.Module) -> str:
    """sha256 of every parameter's bytes, in state-dict order (16 hex)."""
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="one rank of the data-parallel "
                                "self-check")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda: cuda:<rank % cards>)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="default nccl on cuda, gloo on cpu")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="seconds the rendezvous and collectives may wait")
    p.add_argument("--out", default=None,
                   help="rank 0 saves the parameters, the gathered env "
                        "state and the last metrics here (torch.save)")
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    pin_float32()
    pin_deterministic()
    if args.device == "cpu":
        torch.set_num_threads(1)
    device = resolve_device(args.device, args.process_id)
    host_init(args.coordinator, args.num_processes, args.process_id,
              args.dist_backend or default_backend(device), device,
              args.timeout, group_of_one=True)
    try:
        mesh = make_mesh(MeshSpec())
        model, carry, m = run_check(mesh.world, device, args.steps, mesh)
        loss = float(m.loss)
        dig = digest(model)
        state = {f.name: mesh.gather_rows(getattr(carry.env_state, f.name))
                 for f in dataclasses.fields(carry.env_state)}
        if not (np.isfinite(loss) and all(torch.isfinite(p).all()
                                          for p in model.parameters())):
            raise FloatingPointError(f"rank {mesh.rank}: non-finite loss "
                                     f"{loss} or parameters")
        if args.out and mesh.is_lead:
            torch.save({"params": {k: v.cpu() for k, v in
                                   model.state_dict().items()},
                        "env_state": {k: v.cpu() for k, v in state.items()},
                        "metrics": {f: v.cpu() for f, v in
                                    zip(m._fields, m)}}, args.out)
        print(f"MPCHECK rank={mesh.rank} loss={loss:.6f} digest={dig} "
              f"world={mesh.world}", flush=True)
        return {"rank": mesh.rank, "loss": loss, "digest": dig,
                "world": mesh.world}
    finally:
        shutdown()


if __name__ == "__main__":
    main()
