"""Data parallelism over ranks (counterpart of dan_tpu/parallel/)."""
from dan_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    all_reduce_sum,
    barrier,
    gather_objects,
    make_mesh,
    place_replicated,
    shard_batch,
    torchrun_mesh,
)

__all__ = [
    "Mesh",
    "all_reduce_grads",
    "all_reduce_sum",
    "barrier",
    "gather_objects",
    "make_mesh",
    "place_replicated",
    "shard_batch",
    "torchrun_mesh",
]
