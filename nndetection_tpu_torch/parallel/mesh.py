"""The ``(data, model)`` device mesh (counterpart of
:mod:`nndetection_tpu.parallel.mesh`) for one process per device.

``make_mesh`` returns a :class:`torch.distributed.device_mesh.DeviceMesh`
over the process group: ``mesh.get_group("data")`` all-reduces gradients
and gathers validation outputs, ``mesh.get_group("model")`` carries the halo
exchanges and global statistics of :mod:`nndetection_tpu_torch.parallel.spatial`.
Rank ``r`` sits at ``(r // n_model, r % n_model)``.

Where the JAX package annotates arrays with shardings, a process here holds
its own part: ``batch_sharding`` is the slice of the global batch's rows
this process feeds, ``replicate_sharding`` the whole tensor (parameters are
replicated), and ``shard_batch`` cuts a global batch to this process's
rows.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from nndetection_tpu_torch.parallel import distributed

AXES = ("data", "model")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cpu") -> DeviceMesh:
    """A ``(data, model)`` mesh over the process group (defaults to every
    process on ``data``). ``device_type`` is the ranks' device type
    (``"cuda"`` or ``"cpu"``). Needs :func:`distributed.initialize` first."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the {world} processes")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of mesh axis ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.size(AXES.index(axis)))


def batch_sharding(mesh: Optional[DeviceMesh], global_batch_size: int) -> slice:
    """The rows of a global batch of ``global_batch_size`` this process feeds:
    its data index's share, the same on every rank of its model group."""
    if mesh is None:
        return slice(0, global_batch_size)
    return distributed.local_batch_slice(global_batch_size, axis_size(mesh, "model"))


def replicate_sharding(mesh: Optional[DeviceMesh]) -> slice:
    """Parameters are replicated: every process holds the whole tensor."""
    return slice(None)


def shard_batch(mesh: Optional[DeviceMesh], batch: Dict) -> Dict:
    """This process's rows of the global ``batch`` (a dict of arrays or
    tensors with the batch axis first)."""
    n = {len(v) for v in batch.values()}
    if len(n) != 1:
        raise ValueError(f"batch arrays disagree on the batch size: {sorted(n)}")
    rows = batch_sharding(mesh, n.pop())
    return {k: v[rows] for k, v in batch.items()}
