"""Mesh construction (mirrors ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group. A ``DeviceMesh`` spans the ranks of an
initialised ``torch.distributed`` world, one rank per mesh device, so
``make_mesh_from_config`` needs a world of exactly the mesh's size.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (MULTI_POD_MESH, SINGLE_POD_MESH,
                                      MeshConfig, UNIT_MESH)
from repro_torch.device import resolve_device


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH


def make_mesh_from_config(cfg: MeshConfig, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``cfg.shape`` with ``cfg.axes`` as its dim names,
    over the default process group, which must hold ``cfg.num_devices``
    ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {tuple(cfg.shape)} mesh needs an initialised torch.distributed "
            f"world of {cfg.num_devices} ranks; none is initialised")
    world = dist.get_world_size()
    if world != cfg.num_devices:
        raise ValueError(f"a {tuple(cfg.shape)} mesh needs {cfg.num_devices} "
                         f"ranks, the world has {world}")
    return init_device_mesh(device_type, tuple(cfg.shape),
                            mesh_dim_names=tuple(cfg.axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The 16x16 (data, model) mesh, or 2x16x16 (pod, data, model): 256 or
    512 ranks."""
    return make_mesh_from_config(mesh_config(multi_pod=multi_pod),
                                 device_type)


def local_mesh_config(device="cuda") -> MeshConfig:
    """What this program has: (world, 1) over the ranks of an initialised
    ``torch.distributed`` world of more than one rank (a ``torchrun``
    launch: the JAX package's (n, 1) over its devices); else (n, 1) over
    this host's n cards, or the unit mesh for one card or the CPU."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
    else:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return MeshConfig((n, 1), ("data", "model")) if n > 1 else UNIT_MESH
