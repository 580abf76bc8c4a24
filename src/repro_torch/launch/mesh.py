"""Process meshes (port of ``repro.launch.mesh``).

A mesh spans the ranks of an initialized ``torch.distributed`` process
group, one program each.  The caller starts the processes and names the
group's backend (``torch.distributed.init_process_group``, with the
address, world size and rank): NCCL for one rank per card, gloo on the
host or for several ranks sharing one card (NCCL refuses two ranks on one
device).  No backend is chosen or switched here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..dist.parallel import Mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> Mesh:
    """A :class:`~repro_torch.dist.parallel.Mesh` of ``shape`` named
    ``axes`` over the initialized process group (world size = the product
    of ``shape``), rank-major in ``axes`` order.  ``device_type``: where
    the ranks' tensors live (default ``cuda`` when a card is present, else
    ``cpu``)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group(backend, init_method, "
            "world_size, rank) in every rank first")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {shape} holds {n} ranks, the process group "
                         f"{dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> Mesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
