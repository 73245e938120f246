"""Host — one failure domain of the federated fleet (mirrors
``repro.core.host``).

The single-host stack already *is* a host: one ``SVFFManager``
over one ``DevicePool`` with one ``OpJournal`` and a telemetry surface.
This module names that unit so the federation layer
(``core.federation``) can hold many of them, and adds the two things a
multi-host control plane needs from each member:

  * a **lease heartbeat** on an injected clock — the host periodically
    produces a stamped liveness+load payload; the coordinator grants a
    TTL lease against its OWN clock, so a partitioned host simply stops
    renewing and falls out of the routing set (OpenStack Neutron's
    SR-IOV agent ``report_interval``/``agent_down_time`` model);
  * an **epoch fence** — every coordinator op carries its lease epoch
    and the host rejects epochs older than the highest it has accepted
    (``SplitBrainError``), so a stale coordinator that lost a handoff
    can never drive this host again (invariant I15's fencing half).

The serve plane is duck-typed exactly like the manager's tenant
protocol: any occupant exposing ``submit_request``/``SLOTS``/``queue``/
``active`` (``SimServeTenant``, the bench's lite engines) is a routable
engine, whether it is a journaled manager tenant or a registered
lightweight one. A ``Host`` holds no tensor: each of its tenants carries
its own device.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.core.errors import SplitBrainError
from repro_torch.core.journal import OpJournal
from repro_torch.core.manager import SVFFManager
from repro_torch.core.pool import DevicePool
from repro_torch.core.scheduler import AdmissionError
from repro_torch.core.staging import StagingEngine
from repro_torch.core.vf import VFState


class HostTelemetry:
    """Host-local counters the coordinator replicates (a miniature
    ``MetricsBus``: the serve-plane bus stays in ``repro_torch.serve`` —
    core must not import it — but the federation snapshot shape is
    shared)."""

    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.heartbeats = 0
        self.fenced = 0            # ops rejected by the epoch fence

    def describe(self) -> dict:
        return {"submitted": self.submitted, "completed": self.completed,
                "rejected": self.rejected, "heartbeats": self.heartbeats,
                "fenced": self.fenced}


class Host:
    """One ``SVFFManager`` + ``OpJournal`` + ``DevicePool`` + telemetry,
    with a lease heartbeat and an epoch fence. ``clock`` is injected
    (``repro_torch.sim.clock.VirtualClock`` in every test/bench), so lease
    arithmetic is deterministic and wall-clock never leaks into the sim.
    """

    def __init__(self, host_id: str, *,
                 workdir: str,
                 clock,
                 num_devices: int = 8,
                 max_vfs: int = 4,
                 policy: str = "first_fit",
                 lease_ttl: float = 3.0,
                 compact_every: Optional[int] = 256,
                 staging_queues: int = 2,
                 max_load_per_engine: int = 6):
        self.host_id = host_id
        self.clock = clock
        self.policy = policy
        self.lease_ttl = lease_ttl
        self.max_load_per_engine = max_load_per_engine
        self.workdir = workdir
        self.pool = DevicePool(
            devices=tuple(f"{host_id}.d{i}" for i in range(num_devices)),
            max_vfs=max_vfs)
        journal = OpJournal(os.path.join(workdir, "journal"),
                            compact_every=compact_every)
        self.mgr = SVFFManager(
            self.pool, staging=StagingEngine(num_queues=staging_queues),
            workdir=workdir, scheduler=policy, journal=journal)
        #: guest registry — survives a manager crash (the guests live in
        #: their VMs, not the management process); ``recover`` hands this
        #: to ``SVFFManager.recover`` exactly like the chaos harness does
        self.tenants: dict[str, object] = {}
        #: lightweight (non-journaled) engines the scale bench registers;
        #: routable exactly like managed serve tenants
        self.engines: dict[str, object] = {}
        self.telemetry = HostTelemetry()
        self.fence_epoch = 0
        self.last_beat: float = clock.now()

    # ------------------------------------------------------------- liveness
    def heartbeat(self) -> dict:
        """One lease-renewal payload, stamped with the HOST's clock. The
        coordinator turns it into a lease against its own clock — clocks
        never need to agree, only to advance."""
        self.last_beat = self.clock.now()
        self.telemetry.heartbeats += 1
        return {"host_id": self.host_id, "t": self.last_beat,
                "load": self.load(), "capacity": self.capacity()}

    def check_epoch(self, epoch: int) -> None:
        """Fence: reject ops from coordinators older than any this host
        has obeyed; adopt newer epochs (monotone, so I15's fencing check
        is a simple <= over the fleet)."""
        if epoch < self.fence_epoch:
            self.telemetry.fenced += 1
            raise SplitBrainError(
                f"{self.host_id}: op carries epoch {epoch} < fence "
                f"{self.fence_epoch} — stale coordinator rejected")
        self.fence_epoch = epoch

    # ---------------------------------------------------------- serve plane
    def serve_targets(self) -> list:
        """Routable engines, deterministic order: running managed serve
        tenants first (tid order), then registered lite engines."""
        managed = [tn for tid, tn in sorted(self.mgr.tenants.items())
                   if getattr(tn, "status", None) == "running"
                   and hasattr(tn, "submit_request")]
        lite = [e for _, e in sorted(self.engines.items())]
        return managed + lite

    @staticmethod
    def _engine_load(tn) -> int:
        return (len(getattr(tn, "queue", ()))
                + sum(1 for r in getattr(tn, "active", ())
                      if r is not None))

    def load(self) -> int:
        return sum(self._engine_load(tn) for tn in self.serve_targets())

    def capacity(self) -> int:
        return sum(self.max_load_per_engine for _ in self.serve_targets())

    def submit(self, rid: int, *, epoch: int, seed: Optional[int] = None):
        """Admit one federation-routed request onto the least-loaded
        local engine (creation order breaks ties, mirroring
        ``ServeFleet.submit``). Raises ``SplitBrainError`` for a stale
        epoch BEFORE any admission, ``AdmissionError`` when every engine
        is at its load cap."""
        self.check_epoch(epoch)
        targets = self.serve_targets()
        if not targets:
            self.telemetry.rejected += 1
            raise AdmissionError(f"{self.host_id}: no serving engine")
        best, best_load = None, None
        for tn in targets:
            ld = self._engine_load(tn)
            if ld >= self.max_load_per_engine:
                continue
            if best is None or ld < best_load:
                best, best_load = tn, ld
        if best is None:
            self.telemetry.rejected += 1
            raise AdmissionError(
                f"{self.host_id}: every engine at load cap "
                f"{self.max_load_per_engine}")
        req = best.submit_request(rid, seed=seed)
        self.telemetry.submitted += 1
        return best, req

    def owner_engine(self, rid: int):
        """The engine serving ``rid`` here, or None — the coordinator's
        post-heal reconciliation query for in-doubt admissions."""
        for tn in self.serve_targets():
            if getattr(tn, "owns_request", None) and tn.owns_request(rid):
                return tn
        return None

    # ------------------------------------------------------------ telemetry
    def snapshot(self) -> dict:
        """Stamped telemetry snapshot for replication: the coordinator
        keeps the newest it could PULL, and the stamp's age (by the
        coordinator's clock) is what the staleness bound tests."""
        engines = {}
        for tn in self.serve_targets():
            engines[getattr(tn, "tid", repr(tn))] = {
                "load": self._engine_load(tn),
                "slots": int(getattr(tn, "SLOTS", 0)),
            }
        free_vfs = sum(1 for vf in self.pool.vfs.values()
                       if vf.state == VFState.DETACHED
                       and vf.owner is None and vf.devices)
        return {"host_id": self.host_id, "stamp": self.clock.now(),
                "fence_epoch": self.fence_epoch,
                "load": self.load(), "capacity": self.capacity(),
                "max_load": self.max_load_per_engine,
                "free_vfs": free_vfs,
                "engines": engines, "counters": self.telemetry.describe()}

    # ------------------------------------------------------------- recovery
    def recover(self, peer_lookup=None) -> "SVFFManager":
        """Rebuild this host's manager after a crash, from what survives
        the management process: journal + records on disk, the pool, the
        guest registry, the RAM snapshot table. ``peer_lookup`` (wired by
        the federation) lets recovery resolve cross-host migrate entries;
        without it — or with the peer unreachable — those entries defer
        rather than guess (I15/I16)."""
        old = self.mgr
        lookup = peer_lookup if peer_lookup is not None else old.peer_lookup
        self.mgr = SVFFManager.recover(
            old.journal, old.pool, old.records,
            StagingEngine(num_queues=2),
            tenants=dict(self.tenants) or dict(old.tenants),
            snapshots=old.snapshots, workdir=self.workdir,
            pause_enabled=old.pause_enabled, scheduler=self.policy,
            peer_lookup=lookup)
        return self.mgr

    def adopt(self, tenants: dict) -> None:
        """Record the guest registry (objects that survive manager death)."""
        self.tenants.update(tenants)

    def describe(self) -> dict:
        return {"host_id": self.host_id, "policy": self.policy,
                "fence_epoch": self.fence_epoch,
                "lease_ttl": self.lease_ttl,
                "engines": len(self.serve_targets()),
                "load": self.load(), "capacity": self.capacity()}


__all__ = ["Host", "HostTelemetry"]
