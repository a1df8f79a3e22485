"""Data parallelism over ``torch.distributed`` (counterpart of
``nphm_tpu/parallel/mesh.py``).

The JAX package runs one controller over a 1-D device mesh and lets XLA
insert the collectives.  The port runs one process per device, as
``torchrun`` starts them (it sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``), and each parallel entry point says which rows a rank owns
and how the ranks' results meet.  The same two scaling axes as in the JAX
package: training batches, and query points (or subjects) at extraction
and fitting time.

Every collective here is an ``all_reduce`` or a ``broadcast``: gloo's CUDA
support covers those two (and ``barrier``) but not all of the others, and
the same code runs under gloo (the CPU, or several ranks sharing one card)
and NCCL (one rank per card).  ``gather_rows`` is one broadcast per rank,
so a gathered tensor is bit-equal to the blocks the ranks computed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nphm_tpu_torch.utils.params import default_device


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of a 1-D data-parallel group: its process group,
    rank, size, device and backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def get_device_mesh(rank: Optional[int] = None, world_size: Optional[int] = None,
                    init_method: Optional[str] = None, backend: Optional[str] = None,
                    device=None) -> DataMesh:
    """Join (or create) the default process group and return this rank's mesh.

    rank / world_size: default ``RANK`` / ``WORLD_SIZE`` of the environment
    (``torchrun``); init_method: default ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); device: default ``default_device()``, which is
    ``cuda:LOCAL_RANK`` under ``torchrun``; backend: default ``nccl`` for a
    CUDA device, ``gloo`` for the CPU.  NCCL refuses two ranks on one card,
    so ranks sharing a card pass ``backend="gloo"``.  A group that already
    exists is joined as it is; naming another backend or rank than it has
    raises.
    """
    device = default_device() if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, not {device}")
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_rank(), dist.get_world_size())
        want = (backend, have[1] if rank is None else rank,
                have[2] if world_size is None else world_size)
        if have != want:
            raise ValueError(f"the process group is (backend, rank, size) {have}, "
                             f"not {want}")
    else:
        rank = int(os.environ["RANK"]) if rank is None else int(rank)
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    return DataMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device,
                    dist.get_backend())


def device_of(device, mesh: Optional[DataMesh]) -> torch.device:
    """The device an entry point runs on: the one named, else the mesh's,
    else ``default_device()``."""
    if device is not None:
        return torch.device(device)
    return default_device() if mesh is None else mesh.device


def data_parallel(mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    """The mesh if it spans more than one rank, else None (one device)."""
    return mesh if mesh is not None and mesh.size > 1 else None


def is_main(mesh: Optional[DataMesh]) -> bool:
    """Rank 0, or no mesh: the process that writes files and logs."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Optional[DataMesh]) -> None:
    if data_parallel(mesh) is None:
        return
    if mesh.backend == "nccl":
        dist.barrier(mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(mesh.group)


def _starts(n: int, size: int, granule: int):
    """Start rows of the ``size`` contiguous blocks of n rows split in whole
    granules (the earlier blocks one granule larger where they do not
    divide; the last granule may be partial), and n."""
    units = -(-n // granule)
    base, extra = divmod(units, size)
    return [min(n, (r * base + min(r, extra)) * granule) for r in range(size + 1)]


def shard_rows(n: int, mesh: Optional[DataMesh], granule: int = 1) -> slice:
    """Rank r's contiguous block of n rows split in whole ``granule``s
    (every row with no mesh)."""
    if data_parallel(mesh) is None:
        return slice(0, n)
    s = _starts(n, mesh.size, granule)
    return slice(s[mesh.rank], s[mesh.rank + 1])


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """In place: the sum over ranks (every rank gets the same bits)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_reduce_mean(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """In place: the sum over ranks divided by the rank count."""
    return all_reduce_sum(t, mesh).div_(mesh.size)


def gather_rows(block: torch.Tensor, n: int, mesh: DataMesh, granule: int = 1,
                dim: int = 0) -> torch.Tensor:
    """Each rank's ``shard_rows(n, mesh, granule)`` block along ``dim`` ->
    the whole tensor on every rank: one broadcast per rank into the global
    buffer, so the result holds each block's bits."""
    block = block.movedim(dim, 0)
    out = torch.empty((n,) + tuple(block.shape[1:]), dtype=block.dtype, device=block.device)
    s = _starts(n, mesh.size, granule)
    if block.shape[0] != s[mesh.rank + 1] - s[mesh.rank]:
        raise ValueError(f"rank {mesh.rank} holds {block.shape[0]} rows, not its block "
                         f"{s[mesh.rank]}:{s[mesh.rank + 1]} of {n}")
    for r in range(mesh.size):
        part = out[s[r] : s[r + 1]]
        if r == mesh.rank:
            part.copy_(block)
        if part.numel():
            dist.broadcast(part, src=r, group=mesh.group)
    return out.movedim(0, dim)


def broadcast_state(tree, mesh: Optional[DataMesh], src: int = 0):
    """Every tensor leaf of a nested dict / list / tuple overwritten in place
    with rank ``src``'s; returns the tree."""
    if data_parallel(mesh) is None:
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            broadcast_state(v, mesh, src)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            broadcast_state(v, mesh, src)
    elif torch.is_tensor(tree):
        dist.broadcast(tree, src=src, group=mesh.group)
    return tree


def broadcast_arrays(arrays, mesh: DataMesh, dtypes, src: int = 0) -> list:
    """Numpy arrays held by rank ``src`` (others pass None) -> the same
    arrays on every rank; ``dtypes`` names each array's numpy dtype on
    every rank.  Shapes go first, then each array as one tensor on the
    mesh's device."""
    dev = mesh.device
    nd = 8  # rank of the largest array this carries, and room for its shape
    head = torch.zeros((len(dtypes), nd + 1), dtype=torch.int64, device=dev)
    if mesh.rank == src:
        for i, a in enumerate(arrays):
            head[i, 0] = a.ndim
            head[i, 1 : 1 + a.ndim] = torch.tensor(a.shape, dtype=torch.int64)
    dist.broadcast(head, src=src, group=mesh.group)
    out = []
    for i, dt in enumerate(dtypes):
        shape = tuple(head[i, 1 : 1 + int(head[i, 0])].tolist())
        if mesh.rank == src:
            t = torch.from_numpy(np.ascontiguousarray(arrays[i], dtype=dt)).to(dev)
        else:
            t = torch.empty(shape, dtype=torch.from_numpy(np.zeros(0, dt)).dtype, device=dev)
        if t.numel():
            dist.broadcast(t, src=src, group=mesh.group)
        out.append(t.cpu().numpy())
    return out
