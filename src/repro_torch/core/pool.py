"""DevicePool — the Physical Function analogue (paper §II-B; mirrors
``repro.core.pool``).

The pool owns the host's accelerator device slots and carves them into
VFs. The JAX package enumerates ``jax.devices()``; the port's pool takes
its slots from the caller: tokens such as ``"fleetdev0"`` or
``torch.device``s (one card holds every slot), or the ranks of a
``core.ranks.RankPool``, worker processes that a VF's mesh really spans.
A rescan probes the devices it can reach: a torch device, or a rank's
worker.
Like SR-IOV, changing the VF partition requires every VF to be host-
detached (ATTACHED VFs block ``set_num_vfs`` — that is precisely the
limitation the pause functionality works around: PAUSED VFs hold no
devices, so repartitioning proceeds while tenants keep their logical
device).

Invariants (property-tested):
  * device sets of device-holding VFs are pairwise disjoint (IOMMU groups)
  * every VF's devices all come from this pool
  * len(devices(vf)) == prod(vf.mesh_shape)
"""
from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch

from repro_torch.core.ranks import Rank
from repro_torch.core.vf import VFState, VirtualFunction


class PoolError(RuntimeError):
    pass


def _default_mesh_shape(n: int) -> tuple:
    """Factor n into a 2D (data, model) mesh, as square as possible."""
    best = (n, 1)
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            best = (n // d, d)
    return best


class DevicePool:
    def __init__(self, devices: Sequence,
                 pf_id: str = "0000:03:00.0", max_vfs: int = 252):
        # paper §IV-A: QDMA supports up to 4 PFs x 252 VFs
        self.pf_id = pf_id
        self.max_vfs = max_vfs
        self._devices = tuple(devices)
        self.vfs: dict[str, VirtualFunction] = {}
        self._rescanned = False

    # -- discovery ("pci rescan", Table II step 1) -----------------------------
    def rescan(self) -> int:
        t0 = time.perf_counter()
        # validation sweep: confirm every device answers (a one-element
        # round trip, like reading the vendor id of each function on the
        # bus). Plain slot tokens have no bus to probe; a rank's worker
        # answers a ping.
        for d in self._devices:
            if isinstance(d, torch.device):
                torch.zeros(1, device=d).cpu()
            elif isinstance(d, Rank):
                d.pool.probe(d)
        self._rescanned = True
        self.last_rescan_s = time.perf_counter() - t0
        return len(self._devices)

    @property
    def devices(self) -> tuple:
        if not self._rescanned:
            self.rescan()
        return self._devices

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    # -- VF table ----------------------------------------------------------------
    def _check_invariants(self):
        seen = {}
        for vf in self.vfs.values():
            if len(vf.devices) not in (0, math.prod(vf.mesh_shape)):
                raise PoolError(f"{vf.vf_id} holds {len(vf.devices)} "
                                f"devices for mesh {vf.mesh_shape}")
            for d in vf.devices:
                if d in seen:
                    raise PoolError(
                        f"device {d} owned by both {seen[d]} and {vf.vf_id}"
                        " (IOMMU isolation violated)")
                if d not in self.devices:
                    raise PoolError(f"{vf.vf_id} holds foreign device {d}")
                seen[d] = vf.vf_id

    def set_num_vfs(self, n: int, devices_per_vf: Optional[int] = None,
                    mesh_axes: tuple = ("data", "model")) -> list:
        """The SR-IOV 'echo N > sriov_numvfs' analogue.

        Fails if any VF still holds devices in ATTACHED state — the SR-IOV
        limitation the paper describes (§IV-B1): "it requires the removal
        of all the VFs ... before changing it". PAUSED VFs are fine (they
        hold no devices) and survive the repartition.
        """
        if n > self.max_vfs:
            raise PoolError(f"{n} > max_vfs {self.max_vfs}")
        blockers = [vf.vf_id for vf in self.vfs.values()
                    if vf.state == VFState.ATTACHED]
        if blockers:
            raise PoolError(
                f"cannot change #VF while VFs are attached: {blockers} "
                "(detach or pause them first)")
        paused = {k: vf for k, vf in self.vfs.items()
                  if vf.state == VFState.PAUSED}
        self.vfs = dict(paused)          # paused VFs keep their identity
        if n == 0:
            self._check_invariants()
            return []
        per = devices_per_vf or max(1, self.num_devices // n)
        if per * n > self.num_devices:
            raise PoolError(
                f"{n} VFs x {per} devices exceed pool of {self.num_devices}")
        shape = _default_mesh_shape(per)
        created = []
        for i in range(n):
            vf_id = f"{self.pf_id[:-1]}{i + 1}"      # BDF-style .1, .2, ...
            if vf_id in self.vfs:                     # paused survivor
                continue
            vf = VirtualFunction(vf_id=vf_id, mesh_axes=mesh_axes)
            vf.assign_devices(
                self.devices[i * per:(i + 1) * per], shape)
            self.vfs[vf_id] = vf
            created.append(vf)
        self._check_invariants()
        return created

    def free_devices(self) -> list:
        used = {d for vf in self.vfs.values() for d in vf.devices}
        return [d for d in self.devices if d not in used]

    def allocate(self, vf: VirtualFunction, num: int,
                 avoid: Sequence = ()):
        """(Re)assign ``num`` free devices to a VF (unpause onto a possibly
        different slice). ``avoid`` devices are used only as a last resort
        — migration passes the sick slice here so the tenant actually
        lands elsewhere whenever the pool allows it."""
        free = self.free_devices()
        if len(free) < num:
            raise PoolError(f"need {num} devices, only {len(free)} free")
        avoided = set(avoid)
        ordered = ([d for d in free if d not in avoided]
                   + [d for d in free if d in avoided])
        vf.assign_devices(ordered[:num], _default_mesh_shape(num))
        self._check_invariants()

    def find(self, vf_id: str) -> VirtualFunction:
        if vf_id not in self.vfs:
            raise PoolError(f"no such VF {vf_id}")
        return self.vfs[vf_id]

    def query(self) -> dict:
        return {
            "pf_id": self.pf_id,
            "num_devices": self.num_devices,
            "num_vfs": len(self.vfs),
            "free_devices": len(self.free_devices()),
            "vfs": [vf.describe() for vf in self.vfs.values()],
        }
