"""Device meshes over ``torch.distributed`` ranks.

The port of ``graph_hypernetwork_forge_tpu/parallel/mesh.py``. Where JAX
lays a ``Mesh`` over the devices of one process, the port lays a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, one rank per device. The process group is the caller's:
NCCL on the card, gloo on the CPU; :func:`make_mesh` only names its axes.
The axis names are the JAX package's: ``"edge"`` (edge and node
partitioning), ``"model"`` (relation sharding and tensor parallelism),
``"data"`` (data parallelism) and ``"pipe"``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("edge", "model"),
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the initialised default
    process group; with no shape a 1-axis ``("edge",)`` mesh over the world,
    as JAX's defaults to all devices. ``axis_names`` is cut to the mesh's
    rank, as there. ``device_type`` ``None`` is ``"cuda"``; ``"cpu"`` runs
    the mesh on gloo (the tests)."""
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
        axis_names = tuple(axis_names[:1])
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh shape {shape} needs {math.prod(shape)} ranks, the process "
            f"group has {world}"
        )
    axis_names = tuple(axis_names)[: len(shape)]
    return init_device_mesh(
        "cuda" if device_type is None else device_type, shape,
        mesh_dim_names=axis_names,
    )


def mesh_axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of ``axis``, 1 for an axis the mesh lacks."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1
