"""Device meshes over the initialised process group (the reference's
``repro.launch.mesh``).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, ``("data", "model")``, over every rank of the
default process group: one rank a card under NCCL, one rank a process on
the CPU under gloo. The caller initialises the group (address, world size
and rank; nothing on a card's host announces a cluster) and, under NCCL,
sets each rank's card first. The reference's ``make_production_mesh`` (a
16 x 16 TPU pod) has no counterpart.
"""
from __future__ import annotations

import torch.distributed as dist

from ..distributed.fault import elastic_mesh_shape

__all__ = ["make_host_mesh", "elastic_mesh_shape"]


def make_host_mesh(model_axis: int | None = None):
    """A ``(world // m, m)`` mesh named ``("data", "model")`` over the
    default process group, ``m = model_axis or 1``; its device type is
    ``cuda`` under NCCL and ``cpu`` under gloo. Without an initialised
    group it raises: a sharded entry point never falls back to one
    device."""
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "repro_torch: a sharded run needs an initialised process group "
            "(torch.distributed.init_process_group: nccl on the cards, gloo "
            "on the CPU)")
    n = dist.get_world_size()
    m = model_axis or 1
    if n % m:
        raise ValueError(f"model_axis={m} does not divide the world size "
                         f"{n}")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev, (n // m, m),
                            mesh_dim_names=("data", "model"))

