"""VirtualFunction — the SR-IOV VF analogue (paper §II-B, §IV; mirrors
``repro.core.vf``).

A VF is a slice of the device pool: an ordered set of device slots plus
the mesh shape/axes a tenant's state is sharded over. The slots are the
ranks of a ``core.ranks.RankPool`` (worker processes, each a device; the
VF's mesh is a ``DeviceMesh`` over them and a train tenant's state lives
there as DTensors, each rank holding its blocks), or logical slots
(tokens such as ``"fleetdev0"``, or torch devices) of one card, where
the mesh is metadata. Its lifecycle mirrors the VFIO device states in
the paper (fig. 2):

  DETACHED  — exists in the PF's VF table, bound to no tenant (left panel)
  ATTACHED  — bound to a tenant; tenant state lives on its devices (center)
  PAUSED    — tenant still *sees* it (emulated view answers queries) but it
              holds no devices: its host-side resources were released so
              the pool can be repartitioned (right panel)

Transitions are validated — e.g. a PAUSED VF cannot be detached without
unpausing first, exactly like the QEMU implementation refuses config-space
writes on a paused vfio-pci device.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence


class VFState(enum.Enum):
    DETACHED = "detached"
    ATTACHED = "attached"
    PAUSED = "paused"
    ERROR = "error"


_ALLOWED = {
    (VFState.DETACHED, VFState.ATTACHED),
    (VFState.ATTACHED, VFState.PAUSED),
    (VFState.PAUSED, VFState.ATTACHED),    # unpause
    (VFState.ATTACHED, VFState.DETACHED),
    (VFState.ERROR, VFState.DETACHED),     # FLR-style recovery
}


class VFTransitionError(RuntimeError):
    pass


@dataclass
class VirtualFunction:
    vf_id: str                              # BDF-style id, e.g. "0000:03:00.4"
    devices: tuple = ()                     # device slots (empty when PAUSED)
    mesh_shape: tuple = (1, 1)
    mesh_axes: tuple = ("data", "model")
    state: VFState = VFState.DETACHED
    owner: Optional[str] = None             # tenant id
    pausable: bool = True                   # paper: active for Xilinx devices
    # emulated view survives pause (the guest's config-space mirror)
    emulated: dict = field(default_factory=dict)

    def mesh(self):
        """The slice's mesh. On ranks, a ``RankMesh``: every worker of the
        pool builds the ``DeviceMesh`` of these ranks in ``mesh_shape``
        (cached per slice), as the JAX package builds a
        ``jax.sharding.Mesh`` here. On the logical slots of one card, the
        metadata: the slots laid out in ``mesh_shape`` (nested lists) and
        the axis names."""
        if not self.devices:
            raise VFTransitionError(
                f"{self.vf_id} holds no devices ({self.state.value})")
        from repro_torch.core.ranks import is_rank_slice
        if is_rank_slice(self.devices):
            return self.devices[0].pool.mesh(self.mesh_shape,
                                             self.mesh_axes, self.devices)
        devs = list(self.devices)
        for n in reversed(self.mesh_shape[1:]):
            devs = [devs[i:i + n] for i in range(0, len(devs), n)]
        return {"devices": devs, "axes": tuple(self.mesh_axes)}

    @property
    def num_devices(self) -> int:
        return int(math.prod(self.mesh_shape))

    def transition(self, new: VFState):
        if (self.state, new) not in _ALLOWED:
            raise VFTransitionError(
                f"{self.vf_id}: illegal transition {self.state.value} -> "
                f"{new.value}")
        self.state = new

    # -- paper fig. 2 panels --------------------------------------------------
    def release_devices(self) -> tuple:
        """'exit from IOMMU group' — drop device ownership, keep identity."""
        devs, self.devices = self.devices, ()
        return devs

    def assign_devices(self, devices: Sequence, mesh_shape: tuple):
        if len(devices) != math.prod(mesh_shape):
            raise ValueError(f"{self.vf_id}: {len(devices)} devices for "
                             f"mesh {tuple(mesh_shape)}")
        self.devices = tuple(devices)
        self.mesh_shape = tuple(mesh_shape)

    def describe(self) -> dict:
        return {
            "vf_id": self.vf_id, "state": self.state.value,
            "owner": self.owner, "mesh_shape": list(self.mesh_shape),
            "mesh_axes": list(self.mesh_axes),
            "devices": [str(d) for d in self.devices],
            "pausable": self.pausable,
            "emulated": dict(self.emulated),
        }
