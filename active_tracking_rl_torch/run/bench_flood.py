"""Flood backends on one card: seconds per call of each of
``envs/distance.py:distance_fields_backend``'s "xla" (the plain
iteration-capped relaxation), "pallas" (the ``flood_relax`` kernel) and
"pallas_sweep" (the ``flood_sweep`` kernel), at reset-pool scale (512 rows
x 16 goals) on Block and Maze maps.

Port of the repository's root ``bench_flood.py``, with its keys:
``{Block,Maze}PartialNav_{xla,pallas,pallas_sweep}_s`` and
``{Block,Maze}PartialNav_sweep_equals_relax``, the last ``torch.equal`` of
the "pallas" and "pallas_sweep" fields on the first 8 rows. The maps and
the goals (free cells) are drawn from generators seeded 3 and 4, as the
JAX script's keys. Each backend runs 2 untimed calls, then 5 timed ones
between two ``torch.cuda.synchronize()`` calls, as the JAX script's
``timeit``. A
backend that fails raises: no entry becomes an error string, as it does
in the JAX script. Prints one JSON dict (times unrounded).

    python -m active_tracking_rl_torch.run.bench_flood
    python -m active_tracking_rl_torch.run.bench_flood --device cpu --rows 4
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Tuple

import torch

from active_tracking_rl_torch.config import parse_env_id
from active_tracking_rl_torch.envs import maps
from active_tracking_rl_torch.envs.distance import distance_fields_backend
from active_tracking_rl_torch.ops import noise
from active_tracking_rl_torch.run.profile_iter import timeit
from active_tracking_rl_torch.utils.platform import (pin_deterministic,
                                                     pin_float32,
                                                     resolve_device)

ROWS = 512          # the reset pool at 4096 envs
GOALS = 16          # nav_goal_candidates
ENVS = ("Track2D-BlockPartialNav-v0", "Track2D-MazePartialNav-v0")
BACKENDS = ("xla", "pallas", "pallas_sweep")
#: rows of the sweep-equals-relax check
CHECK_ROWS = 8


def flood_inputs(env_id: str, rows: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`rows` level-0 maps of `env_id` and GOALS distinct free cells each."""
    ecfg = parse_env_id(env_id)
    gen = noise.generator(3, device)
    mz = maps.generate_map(ecfg, maps.draw_map(ecfg, rows, gen, device))
    gen = noise.generator(4, device)
    gumbel = noise.gumbel((rows, ecfg.maze_size ** 2), gen, device)
    return mz, maps.sample_free_cells(gumbel, mz, GOALS)


def bench_flood(rows: int = ROWS, device="cuda", iters: int = 5,
                warmup: int = 2) -> Dict:
    """Every backend's seconds per call on both map families, and whether
    the two kernels' fields are equal, by the JAX script's keys."""
    dev = resolve_device(device)
    results: Dict = {}
    for env_id in ENVS:
        iters_cap = parse_env_id(env_id).flood_iters
        mz, goals = flood_inputs(env_id, rows, dev)
        key = env_id.split("-")[1]
        for backend in BACKENDS:
            results[f"{key}_{backend}_s"] = timeit(
                lambda b=backend: distance_fields_backend(mz, goals,
                                                          iters_cap, b),
                dev, iters, warmup)
        # the two kernels' fields must be one BFS, capped at the same depth
        a = distance_fields_backend(mz[:CHECK_ROWS], goals[:CHECK_ROWS],
                                    iters_cap, "pallas")
        b = distance_fields_backend(mz[:CHECK_ROWS], goals[:CHECK_ROWS],
                                    iters_cap, "pallas_sweep")
        results[f"{key}_sweep_equals_relax"] = bool(torch.equal(a, b))
    return results


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="seconds per call of each flood "
                                "backend at reset-pool scale")
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for small runs)")
    return p


def main(argv=None) -> Dict:
    args = build_argparser().parse_args(argv)
    pin_float32()
    pin_deterministic()
    out = bench_flood(args.rows, args.device)
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
