"""VF placement scheduler — admission control + placement policies (a
copy of ``repro.core.scheduler``).

The paper's SVFF manager attaches a VM to "the first detached VF" (the
libvirt behaviour). At fleet scale that is a placement *policy decision*,
so the manager delegates it here. A ``Scheduler`` answers two questions:

  admit(pool, tenants, request)   may this attach proceed at all?
                                  (raises AdmissionError with the reason)
  select(pool, tenants, request)  which detached VF gets the tenant?

Policies (``make_scheduler(name)`` / ``RunConfig.placement``):

  first_fit   first detached VF in PF table order — the paper/libvirt
              behaviour, and the default.
  best_fit    detached VF with the FEWEST devices that still satisfies
              ``min_devices`` (bin-packing by device count: keeps big
              slices free for big tenants).
  fair_share  detached VF whose device count is closest to the fair share
              ``pool devices / (occupied tenants + 1)`` — spreads capacity
              evenly across tenants.

All policies are deterministic (ties break in PF table order) so a
simulation can replay placements from a seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from repro_torch.core.pool import DevicePool, PoolError
from repro_torch.core.vf import VFState, VirtualFunction


class AdmissionError(PoolError):
    """Attach rejected by admission control (no capacity / bad request)."""


class GangPlacementError(AdmissionError):
    """Gang attach rejected: fewer than K placeable VFs. Raised BEFORE any
    member binds, so a failed gang admission leaves no leaked VFs and no
    half-bound stages."""


@dataclasses.dataclass(frozen=True)
class PlacementRequest:
    """What a tenant asks of the scheduler."""
    tenant_id: str
    min_devices: int = 1


class Scheduler:
    """Base policy: candidate filtering + admission; subclasses rank."""

    name = "base"

    # -- candidate set ------------------------------------------------------
    @staticmethod
    def candidates(pool: DevicePool,
                   request: PlacementRequest) -> list[VirtualFunction]:
        """Detached, unowned VFs large enough for the request, in PF table
        order (dict insertion order == creation order)."""
        return [vf for vf in pool.vfs.values()
                if vf.state == VFState.DETACHED and vf.owner is None
                and len(vf.devices) >= request.min_devices]

    # -- admission control --------------------------------------------------
    def admit(self, pool: DevicePool, tenants: Dict[str, object],
              request: PlacementRequest) -> None:
        tn = tenants.get(request.tenant_id)
        if tn is not None and getattr(tn, "status", None) in ("running",
                                                             "paused"):
            raise AdmissionError(
                f"{request.tenant_id} already holds VF "
                f"{getattr(tn, 'vf_id', None)} ({tn.status})")
        if request.min_devices < 1:
            raise AdmissionError(
                f"{request.tenant_id}: min_devices must be >= 1")
        if not self.candidates(pool, request):
            raise AdmissionError(
                f"no detached VF with >= {request.min_devices} device(s) "
                f"for {request.tenant_id} (increase num_vfs via reconf)")

    # -- placement ----------------------------------------------------------
    def choose(self, pool: DevicePool, tenants: Dict[str, object],
               request: PlacementRequest,
               cands: Sequence[VirtualFunction]) -> VirtualFunction:
        raise NotImplementedError

    def select(self, pool: DevicePool, tenants: Dict[str, object],
               request: PlacementRequest) -> VirtualFunction:
        self.admit(pool, tenants, request)
        return self.choose(pool, tenants, request,
                           self.candidates(pool, request))

    # -- gang placement -----------------------------------------------------
    def admit_gang(self, pool: DevicePool, tenants: Dict[str, object],
                   requests: Sequence[PlacementRequest]) -> None:
        """Admission for an all-or-nothing gang of K attaches: every member
        must be individually admissible AND there must be K DISTINCT
        candidate VFs. Raises ``GangPlacementError`` without touching the
        pool — atomicity by validation-before-mutation."""
        if not requests:
            raise GangPlacementError("empty gang placement request")
        for req in requests:
            try:
                self.admit(pool, tenants, req)
            except AdmissionError as e:
                raise GangPlacementError(
                    f"gang of {len(requests)}: member "
                    f"{req.tenant_id} not admissible: {e}") from e
        # K distinct VFs must exist for the WIDEST min_devices ordering:
        # greedily match each request (largest demand first) to a distinct
        # candidate; any unmatched request fails the whole gang
        taken: set = set()
        for req in sorted(requests, key=lambda r: -r.min_devices):
            got = next((vf for vf in self.candidates(pool, req)
                        if vf.vf_id not in taken), None)
            if got is None:
                raise GangPlacementError(
                    f"gang of {len(requests)}: only {len(taken)} distinct "
                    f"VF(s) placeable, member {req.tenant_id} "
                    f"(min_devices={req.min_devices}) has none left")
            taken.add(got.vf_id)

    def select_gang(self, pool: DevicePool, tenants: Dict[str, object],
                    requests: Sequence[PlacementRequest]
                    ) -> list[VirtualFunction]:
        """Pick K distinct VFs for a gang, in request order, using the
        policy's ``choose`` restricted to not-yet-taken candidates. Calls
        ``admit_gang`` first, so failure is typed and side-effect-free."""
        self.admit_gang(pool, tenants, requests)
        picks: list[VirtualFunction] = []
        taken: set = set()
        for req in requests:
            cands = [vf for vf in self.candidates(pool, req)
                     if vf.vf_id not in taken]
            vf = self.choose(pool, tenants, req, cands)
            picks.append(vf)
            taken.add(vf.vf_id)
        return picks

    def describe(self) -> dict:
        return {"policy": self.name}


class FirstFitScheduler(Scheduler):
    """PF table order — the paper's 'first detached VF' scan."""

    name = "first_fit"

    def choose(self, pool, tenants, request, cands):
        return cands[0]


class BestFitScheduler(Scheduler):
    """Smallest sufficient slice (bin-packing by device count)."""

    name = "best_fit"

    def choose(self, pool, tenants, request, cands):
        return min(cands, key=lambda vf: len(vf.devices))


class FairShareScheduler(Scheduler):
    """Slice closest to the per-tenant fair share of pool devices."""

    name = "fair_share"

    def choose(self, pool, tenants, request, cands):
        occupied = sum(1 for vf in pool.vfs.values()
                       if vf.owner is not None)
        share = pool.num_devices / (occupied + 1)
        return min(cands, key=lambda vf: abs(len(vf.devices) - share))


_POLICIES = {cls.name: cls for cls in
             (FirstFitScheduler, BestFitScheduler, FairShareScheduler)}
POLICY_NAMES = tuple(sorted(_POLICIES))
_INSTANCES: dict[str, Scheduler] = {}


def make_scheduler(policy: str) -> Scheduler:
    """Policy name -> (cached, stateless) scheduler instance."""
    if policy not in _POLICIES:
        raise KeyError(f"unknown placement policy {policy!r}; "
                       f"have {list(POLICY_NAMES)}")
    if policy not in _INSTANCES:
        _INSTANCES[policy] = _POLICIES[policy]()
    return _INSTANCES[policy]

