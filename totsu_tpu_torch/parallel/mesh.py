"""Device meshes (port of ``totsu_tpu.parallel.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over the devices one
process sees. The port runs one process per device (SPMD), so a mesh is
a ``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
over the ranks of the process group, with named dimensions; each axis's
group is ``mesh.get_group(name)`` and this rank's place on it
``mesh.get_local_rank(name)``. The groups take the process group's
backend (``multihost.init``: NCCL on the card, gloo when asked).
"""

from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def local_mesh(axis_sizes: Mapping[str, int],
               devices: Optional[str] = None) -> DeviceMesh:
    """A mesh with the named axes and sizes of ``axis_sizes`` over the
    first ranks of the process group, on the device type ``devices``
    ("cuda" unless the caller passes "cpu"). Every rank of the group calls
    it. Raises ``RuntimeError`` when no process group is initialized and
    ``ValueError`` when the mesh needs more ranks than the world has."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call "
            "totsu_tpu_torch.parallel.multihost.init() (or run under "
            "torchrun and init) before making a mesh")
    device_type = torch.device(devices or "cuda").type
    sizes = tuple(int(s) for s in axis_sizes.values())
    need = int(np.prod(sizes))
    world = dist.get_world_size()
    if need > world:
        raise ValueError(f"mesh needs {need} ranks, have {world}")
    return init_device_mesh(device_type, sizes,
                            mesh_dim_names=tuple(axis_sizes.keys()))


def make_mesh(batch: int = 1, row: int = 1,
              devices: Optional[str] = None) -> DeviceMesh:
    """The solver's canonical 2-axis mesh: ``batch`` (data parallel over
    problem instances) x ``row`` (the constraint matrix's rows split over
    ranks, the analogue of tensor parallelism)."""
    return local_mesh({"batch": batch, "row": row}, devices)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``; ``TypeError`` for anything that
    is not a mesh, ``ValueError`` for an axis it does not have."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a DeviceMesh (parallel.make_mesh), got "
                        f"{type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
    return mesh.size(names.index(axis))
