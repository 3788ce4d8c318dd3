"""Data parallelism over ranks with torch.distributed (counterpart of
dan_tpu/parallel/mesh.py).

One rank is one process and one device.  The global batch is split into
contiguous rows, one block a rank; the parameters, the momentum and the
step are replicated; the train step sums the gradients over the ranks
(`all_reduce_grads`) and every rank applies the same update.

    mesh = make_mesh(cfg.mesh)                  # under torchrun: cuda:LOCAL_RANK, NCCL
    mesh = make_mesh(cfg.mesh, "cpu", backend="gloo", rank=r, world_size=n,
                     init_method="file:///tmp/pg")   # spawned ranks on the CPU
    place_replicated(state, mesh)               # rank 0's state on every rank
    rows = shard_batch(global_host_batch, mesh)

Backends: NCCL between cards; gloo on the CPU, or for ranks that share one
card (NCCL refuses two ranks on one GPU).  NCCL is used unless the caller
names gloo, and a failed init raises.  Host-side gathers (the TTA rows and
results) go through a gloo group under every backend (`Mesh.host_group`).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from dan_tpu_torch.config import MeshConfig

# How long a collective may wait for the other ranks before it raises: a
# rank that died leaves the others blocked in one.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass
class Mesh:
    """A 1-D data-parallel layout: this process's rank of `size`, its
    device and backend (the default process group's, which the collectives
    on the device take) and a gloo group for host-side gathers (None: the
    default group is gloo already)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    host_group: Any = None

    def rows(self, batch_size: int) -> slice:
        """This rank's contiguous rows of a global batch of batch_size."""
        if batch_size % self.size:
            raise ValueError(
                f"global batch {batch_size} does not split over {self.size} ranks"
            )
        per = batch_size // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def close(self, sync: bool = True) -> None:
        """Destroy the process group (every rank calls it at the end).

        sync: first wait for every rank (a barrier, bounded by the group's
        timeout), so that no rank tears down its connections while another
        still reads from them; gloo aborts a rank whose peer closed a pair
        mid-exchange.  A rank that failed passes False: it has no barrier
        to meet, the others may be stuck in a collective."""
        if dist.is_initialized():
            if sync:
                dist.barrier()
            dist.destroy_process_group()

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """close(), with the barrier only when the block raised nothing."""
        self.close(sync=exc_type is None)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def make_mesh(
    config: MeshConfig = MeshConfig(),
    device=None,
    *,
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> Mesh:
    """Join (or start) the process group and describe this rank.

    Under torchrun the rank, the world size and the local rank come from
    its environment and the group meets at env://; spawned ranks pass
    rank, world_size and init_method (e.g. file:///<dir>/pg) themselves.
    device: this rank's device; default cuda:LOCAL_RANK, which raises
    without a card.  backend: "nccl" (the default) or "gloo".
    config.data_parallel_size: -1 means every rank of the launch; another
    value must equal the world size."""
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if rank is None:
        rank = _env_int("RANK")
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None or world_size is None:
        raise ValueError(
            "no rank: run under torchrun, or pass rank, world_size and init_method"
        )
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a rank runs on cuda:LOCAL_RANK by default; pass "
                'device="cpu" and backend="gloo" to run ranks on the CPU'
            )
        local = _env_int("LOCAL_RANK")
        device = torch.device("cuda", rank if local is None else local)
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs between CUDA devices: name backend='gloo' for the CPU")
    if config.data_parallel_size not in (-1, world_size):
        raise ValueError(
            f"data_parallel_size {config.data_parallel_size} != world size {world_size}"
        )
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
            raise ValueError("the process group already has another rank or size")
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    else:
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size, timeout=timeout,
        )
    host_group = None if backend == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    return Mesh(rank=rank, size=world_size, device=device, backend=backend,
                host_group=host_group)


def torchrun_mesh(config: MeshConfig = MeshConfig(), device=None) -> Optional[Mesh]:
    """The CLIs' mesh: None unless torchrun started this process (RANK is
    set); then make_mesh on `device` (default cuda:LOCAL_RANK) with NCCL,
    or gloo when `device` is the CPU."""
    if "RANK" not in os.environ:
        return None
    device = None if device is None else torch.device(device)
    backend = "gloo" if device is not None and device.type == "cpu" else "nccl"
    return make_mesh(config, device, backend=backend)


def shard_batch(host_batch: Mapping[str, np.ndarray], mesh: Mesh) -> Dict[str, np.ndarray]:
    """This rank's contiguous rows of every array of a global host batch
    (views, not copies)."""
    rows = mesh.rows(len(next(iter(host_batch.values()))))
    return {k: v[rows] for k, v in host_batch.items()}


@torch.no_grad()
def place_replicated(state, mesh: Mesh):
    """Make every rank's train state rank 0's: parameters, momentum and
    step, broadcast in place.  Returns state."""
    tensors = [p for _, p in state.model.named_parameters()]
    tensors += [state.momentum[n] for n, _ in state.model.named_parameters()]
    step = torch.tensor([state.step], dtype=torch.int64, device=mesh.device)
    for t in tensors + [step]:
        dist.broadcast(t, 0)
    state.step = int(step.item())
    return state


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of t over the ranks (a new tensor; t is left as it is)."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_grads(
    grads: Mapping[str, torch.Tensor],
    extra: Mapping[str, torch.Tensor],
    mesh: Mesh,
):
    """Sum float32 gradients over the ranks through one flat buffer, in the
    order of `grads`: one collective.  `extra` float32 tensors (the step's
    metrics, 0-d, and debug_nans' one-hot row) ride in the same buffer.
    The sums are copied back into the gradient tensors, in place: views
    into the buffer would start at other alignments, and a reduction over
    them (the global norm) can sum in another order.  Returns (grads,
    summed extra, each a view of the buffer in its tensor's shape)."""
    parts = [g.reshape(-1) for g in grads.values()]
    parts += [v.to(torch.float32).reshape(-1) for v in extra.values()]
    flat = torch.cat(parts)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    views, i = [], 0
    for g in grads.values():
        views.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    torch._foreach_copy_(list(grads.values()), views)
    summed = {}
    for k, v in extra.items():
        summed[k] = flat[i:i + v.numel()].view(v.shape)
        i += v.numel()
    return dict(grads), summed


def gather_objects(obj, mesh: Mesh) -> List[Any]:
    """Every rank's `obj`, in rank order, on every rank: pickled over the
    host group, so numpy arrays and dicts of them travel as they are."""
    out: List[Any] = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.host_group)
    return out


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (on the host group)."""
    dist.barrier(group=mesh.host_group)
