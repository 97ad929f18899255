"""Data parallelism over ``torch.distributed``: one process per device.

Port of ``active_tracking_rl_tpu/parallel/mesh.py``. The JAX package runs
one SPMD program over a ('dp', 'tp') device mesh and XLA inserts the
gradient all-reduce from the shardings. Here each process (a rank) drives
one device, holds a replica of the parameters and its block of the env
rows, and the learner calls the collectives itself:

* :func:`host_init` joins the process group (a ``tcp://`` rendezvous with a
  finite timeout, so a missing rank raises instead of hanging); it does
  nothing for one process unless asked for a group of one.
* :class:`MeshSpec` names the mesh as in JAX; ``tp`` must be 1, as the JAX
  mesh only ever had it (the model is replicated).
* :func:`make_mesh` gives this process's :class:`Mesh`: its rank, the world
  size W and the collectives; without a process group, ``Mesh()``, a mesh
  of one rank whose collectives are the identity:

  - :meth:`Mesh.rows`: the rank's block of n global rows, the blocks of
    JAX's ``P("dp")``;
  - :meth:`Mesh.average_grads_`: every gradient summed over the ranks and
    divided by W, before the optimizer's clip at the global norm, so the
    clip sees the global gradient as it does after XLA's psum; the step's
    metric sums ride in the same all-reduce;
  - :meth:`Mesh.all_reduce_sum`, :meth:`Mesh.gather_rows` (rank order: the
    checkpoint's carry) and :meth:`Mesh.broadcast_` (rank 0's parameters).

With ``gloo`` the collectives run on CPU copies (gloo takes CUDA tensors in
only some collectives); with ``nccl`` on the device. NCCL takes one card per
rank: two ranks on one card fail with its "Duplicate GPU detected" error,
so several ranks share a card only over gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

#: seconds a rendezvous or a collective may wait for the other ranks
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = -1   # -1: every rank
    tp: int = 1

    def __post_init__(self):
        if self.tp != 1:
            raise ValueError(f"MeshSpec(tp={self.tp}): the model is "
                             f"replicated, only tp=1 exists")


def host_init(coordinator: Optional[str] = None, num_processes: int = 1,
              process_id: int = 0, backend: str = "gloo",
              device: Optional[torch.device] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S,
              group_of_one: bool = False) -> None:
    """Join the process group of `num_processes` ranks at `coordinator`
    (host:port, where rank 0 listens). Nothing for one process unless
    `group_of_one` (a check of the backend on one device); a second call
    with the same world and rank is a no-op. Raises if the other ranks do
    not arrive within `timeout_s`."""
    if num_processes == 1 and not group_of_one:
        return
    if not coordinator:
        raise ValueError(f"--num-processes {num_processes} needs "
                         f"--coordinator host:port (rank 0's address)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not a rank of "
                         f"{num_processes} processes")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                         process_id):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks (rank "
                f"{dist.get_rank()}) is already joined")
        return
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the data-parallel mesh and its collectives.

    `backend` None means no process group: one process, every collective
    the identity (``Mesh()``).
    """

    world: int = 1
    rank: int = 0
    backend: Optional[str] = None

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's block of n global rows."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} ranks")
        b = n // self.world
        return self.rank * b, (self.rank + 1) * b

    def _comm_device(self, t: torch.Tensor) -> torch.device:
        return torch.device("cpu") if self.backend == "gloo" else t.device

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks (a new tensor on t's device)."""
        if self.backend is None:
            return t.clone()
        buf = t.detach().to(self._comm_device(t), copy=True)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        return buf.to(t.device)

    @torch.no_grad()
    def average_grads_(self, params: Iterable[torch.nn.Parameter],
                       extra: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
        """Every parameter's gradient <- its sum over the ranks / W, and
        the sum of the 1-d `extra` over the ranks returned, in one
        all-reduce. A missing gradient counts as zeros (and is one after):
        the ranks then agree on which gradients exist, and the optimizers
        step a zero gradient as they step a missing one. Without a process
        group nothing changes and `extra` comes back as it is."""
        if self.backend is None:
            return extra
        params = list(params)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        parts = [g.reshape(-1) for g in grads]
        if extra is not None:
            parts.append(extra.detach().to(parts[0].dtype))
        flat = self.all_reduce_sum(torch.cat(parts))
        off = 0
        for p, g in zip(params, grads):
            p.grad = flat[off:off + g.numel()].view_as(g).div_(self.world)
            off += g.numel()
        return None if extra is None else flat[off:].to(extra.dtype)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes), concatenated in rank order along
        the rows."""
        if self.backend is None:
            return t
        as_bool = t.dtype == torch.bool
        src = (t.to(torch.uint8) if as_bool else t).contiguous()
        src = src.to(self._comm_device(t))
        parts: List[torch.Tensor] = [torch.empty_like(src)
                                     for _ in range(self.world)]
        dist.all_gather(parts, src)
        out = torch.cat(parts).to(t.device)
        return out.to(torch.bool) if as_bool else out

    @torch.no_grad()
    def broadcast_(self, tensors: Iterable[torch.Tensor], src: int = 0
                   ) -> None:
        """Overwrite `tensors` in place with rank `src`'s values."""
        if self.backend is None:
            return
        for t in tensors:
            buf = t.detach().to(self._comm_device(t), copy=True)
            dist.broadcast(buf, src)
            t.copy_(buf)


def make_mesh(spec: MeshSpec = MeshSpec()) -> Mesh:
    """This process's Mesh: over the joined process group, or ``Mesh()``
    (one rank, no collectives) without one. `spec.dp` must be -1 or the
    world size."""
    mesh = (Mesh(dist.get_world_size(), dist.get_rank(), dist.get_backend())
            if dist.is_initialized() else Mesh())
    if spec.dp not in (-1, mesh.world):
        raise ValueError(f"MeshSpec(dp={spec.dp}) over {mesh.world} ranks: "
                         f"one rank per device, dp must be -1 or "
                         f"{mesh.world}")
    return mesh


def free_port() -> int:
    """A TCP port on localhost that is free now (a coordinator's)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
