"""The (data, fsdp) mesh of the ranks, and which rows and which parameter
dims each rank holds.

Counterpart of ``dmtpu/parallel/mesh.py``.  The JAX package runs one
program over a ``jax.sharding.Mesh`` of devices; here each rank is a
process (``torchrun``), the mesh is a ``torch.distributed`` ``DeviceMesh``
of dims ``("data", "fsdp")`` over every rank of the process group, and a
rank holds its rows of the global batch: the batch is split over both dims
together, rank ``r`` of ``n`` taking rows ``[r * B / n, (r + 1) * B / n)``.
Parameters are replicated, or sharded over ``fsdp`` by the JAX package's
rule (``shard_dim``: the largest dim when it divides, else none), which
``parallel/train.py::shard_train_state`` applies.

``init_distributed`` starts the process group of a ``torchrun`` launch
(NCCL on ``cuda:LOCAL_RANK``, gloo when the caller asks for the CPU).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


def launched() -> bool:
    """Whether this process was started by ``torchrun`` (``WORLD_SIZE`` set)."""
    return "WORLD_SIZE" in os.environ


def init_distributed(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device of this rank, after starting the process group of a
    ``torchrun`` launch from its ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
    (and ``MASTER_ADDR`` / ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, or
    gloo when ``device`` is the CPU.  Outside a launch, or with the group
    already started, nothing is started; the device is ``device`` (on CUDA,
    ``cuda:LOCAL_RANK`` under a launch)."""
    device = torch.device(device)
    if device.type == "cuda" and launched():
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if launched() and not dist.is_initialized():
        kw = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return device


def _device_type(devices: Any) -> str:
    if devices is not None:
        return torch.device(devices).type if not isinstance(devices, (list, tuple)) \
            else torch.device(devices[0]).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(devices: Any = None, fsdp: int = 1) -> DeviceMesh:
    """The (data, fsdp) mesh over every rank of the process group; without a
    group, a one-rank group is started (gloo, or NCCL for ``devices="cuda"``)
    and the mesh is that rank.  ``devices``: the device type ("cuda" or
    "cpu", or a device or list of devices of that type); by default the
    group's (NCCL: CUDA)."""
    if not dist.is_initialized():
        device_type = "cpu" if devices is None else _device_type(devices)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if n % fsdp != 0:
        raise ValueError(f"fsdp={fsdp} must divide device count {n}")
    return init_device_mesh(_device_type(devices), (n // fsdp, fsdp),
                            mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


def mesh_size(mesh: Optional[DeviceMesh], axis: Optional[str] = None) -> int:
    """The ranks of ``mesh`` (of its dim ``axis``); 1 without a mesh."""
    if mesh is None:
        return 1
    return mesh.size() if axis is None else mesh[axis].size()


def mesh_rank(mesh: Optional[DeviceMesh]) -> int:
    """This rank's place in ``mesh`` with its dims flattened (data-major),
    which is the block of the batch it holds; 0 without a mesh."""
    if mesh is None:
        return 0
    return mesh.get_local_rank(DATA_AXIS) * mesh[FSDP_AXIS].size() + \
        mesh.get_local_rank(FSDP_AXIS)


def batch_sharding(mesh: DeviceMesh) -> Tuple[Shard, Shard]:
    """The batch's placements: its leading dim split over data, then fsdp
    (which also sees data)."""
    return (Shard(0), Shard(0))


def replicated_sharding(mesh: DeviceMesh) -> Tuple[Replicate, Replicate]:
    return (Replicate(), Replicate())


def batch_rows(batch: int, mesh: Optional[DeviceMesh], micro_batches: int = 1) -> Any:
    """This rank's rows of a global batch of ``batch`` rows: a slice, or with
    ``micro_batches`` > 1 its block of each micro-batch in turn (an index
    array), so that its own split into ``micro_batches`` parts holds its
    rows of each global micro-batch."""
    n = mesh_size(mesh)
    if batch % (n * micro_batches):
        raise ValueError(f"batch {batch} not divisible by the mesh's {n} ranks x "
                         f"{micro_batches} micro-batches")
    k, r = batch // (n * micro_batches), mesh_rank(mesh)
    if micro_batches == 1:
        return slice(r * k, (r + 1) * k)
    return np.concatenate([np.arange(i * n * k + r * k, i * n * k + (r + 1) * k)
                           for i in range(micro_batches)])


def shard_batch(batch: Any, mesh: Optional[DeviceMesh], micro_batches: int = 1) -> Any:
    """This rank's rows of a global batch (a tensor or array, a list of
    captions, or a dict / tuple / list of them), by ``batch_rows``."""
    if mesh_size(mesh) == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, micro_batches) for k, v in batch.items()}
    if isinstance(batch, list) and batch and isinstance(batch[0], str):  # captions
        rows = batch_rows(len(batch), mesh, micro_batches)
        return batch[rows] if isinstance(rows, slice) else [batch[i] for i in rows]
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh, micro_batches) for v in batch)
    rows = batch_rows(batch.shape[0], mesh, micro_batches)
    if isinstance(batch, torch.Tensor) and not isinstance(rows, slice):
        rows = torch.as_tensor(rows, device=batch.device)
    return batch[rows]


def all_gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x`` (of ``group``, in rank order), concatenated along
    ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def is_main() -> bool:
    """Rank 0 of the process group, or no group: the rank that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shard_dim(shape: Tuple[int, ...], fsdp: int) -> Optional[int]:
    """The JAX package's fsdp rule for one parameter: its largest dim (the
    first of equals) when ``fsdp`` divides it, else None (replicated); None
    for ``fsdp == 1`` and scalars."""
    if fsdp == 1 or len(shape) == 0:
        return None
    axis = int(np.argmax(shape))
    return axis if shape[axis] % fsdp == 0 else None


def param_sharding(mesh: DeviceMesh, params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Tuple[Any, Any]]:
    """Per parameter (by name) its placements over (data, fsdp): replicated,
    or ``shard_dim`` split over fsdp."""
    fsdp = mesh_size(mesh, FSDP_AXIS)
    out = {}
    for name, p in params.items():
        dim = shard_dim(tuple(p.shape), fsdp)
        out[name] = (Replicate(), Replicate() if dim is None else Shard(dim))
    return out
