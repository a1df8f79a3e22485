"""Data parallelism over ``torch.distributed``, one process per device
(counterpart of ``nphm_tpu/parallel``)."""

from nphm_tpu_torch.parallel.mesh import (
    DataMesh,
    all_reduce_mean,
    all_reduce_sum,
    barrier,
    broadcast_arrays,
    broadcast_state,
    data_parallel,
    device_of,
    gather_rows,
    get_device_mesh,
    is_main,
    shard_rows,
)

__all__ = [
    "DataMesh",
    "all_reduce_mean",
    "all_reduce_sum",
    "barrier",
    "broadcast_arrays",
    "broadcast_state",
    "data_parallel",
    "device_of",
    "gather_rows",
    "get_device_mesh",
    "is_main",
    "shard_rows",
]
