"""Data-parallel ranks of the port for the CPU tests.

``launch(fn, world, args)`` starts `world` spawned processes, each on one
CPU thread, which call ``fn(rank, world, coordinator, *args)``; `fn` joins
the gloo group at `coordinator` (a free localhost port) itself. Results
(pickled) come back in rank order. Every wait has a timeout: a rank that hangs or
fails kills the others and fails the test with its traceback. `fn` must be
importable by name (module level), from a module that does not import JAX.
"""

from __future__ import annotations

import multiprocessing
import pickle
import queue
import time
import traceback

import torch

from active_tracking_rl_torch.parallel.mesh import free_port


def _entry(fn, rank, world, coordinator, args, results):
    torch.set_num_threads(1)
    try:
        # plain pickle bytes: the queue's own pickler would hand tensors
        # over as shared memory, gone when this process exits
        results.put((rank, True, pickle.dumps(fn(rank, world, coordinator,
                                                 *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def launch(fn, world: int, args=(), timeout: float = 240.0) -> list:
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_entry, args=(fn, r, world, coordinator,
                                              tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:
            try:
                rank, ok, value = results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"{world - len(out) - len(errors)} of "
                                   f"{world} ranks gave no result within "
                                   f"{timeout} s") from None
            if ok:
                out[rank] = pickle.loads(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return [out[r] for r in range(world)]
