"""Meshes (counterpart of ``repro.launch.mesh``).

Single pod: 16 x 16 = 256 ranks, axes ``("data", "model")``. Multi-pod: 2 x
16 x 16 = 512 ranks, axes ``("pod", "data", "model")``: the "pod" axis
extends data parallelism across the pod boundary, the inner two stay inside
it. A production mesh needs a process group of at least 256 or 512 ranks,
which only the dry run has (a fake one: :mod:`repro_torch.launch.dryrun`);
:func:`make_host_mesh` builds one over the ranks this job really has.

Functions, not module constants: importing this module touches no process
group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.fault import largest_mesh_shape


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu") -> DeviceMesh:
    """The 256- or 512-rank production mesh over the first ranks of the
    current process group, which must have at least that many."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if dist.get_world_size() < n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, the group has "
                           f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).view(shape), mesh_dim_names=axes)


def make_host_mesh(*, model_parallel: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank of the process group,
    ``model_parallel`` wide on the model axis (at most the world)."""
    n = dist.get_world_size()
    data, model = largest_mesh_shape(n, model_parallel=min(model_parallel, n))
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def mesh_axis_size(mesh, name: str, default: int = 1) -> int:
    """The size of mesh axis ``name``, ``default`` where the mesh has none."""
    names = tuple(mesh.mesh_dim_names)
    return mesh.shape[names.index(name)] if name in names else default
