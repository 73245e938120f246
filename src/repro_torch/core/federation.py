"""FederationCoordinator — lease-based cross-host control plane (mirrors
``repro.core.federation``).

One ``SVFFManager`` is one failure domain; this module federates many
``Host``s (``core.host``) behind a coordinator that:

  * tracks **host liveness with TTL leases** on an injected clock — a
    host that stops heartbeating (crashed or partitioned) falls out of
    the routing set when its lease lapses, exactly like an OpenStack
    Neutron agent going stale past ``agent_down_time``;
  * **routes admissions across hosts** through the same three scheduler
    policy names the VF placement layer uses
    (``core.scheduler.choose_host``), over **replicated telemetry
    snapshots with staleness bounds** — a snapshot older than
    ``max_staleness`` disqualifies its host from routing, and an
    autoscale plan built from stale evidence is suppressed (the
    ``TelemetrySnapshot.age_s`` / ``AutoscaleConfig.max_staleness_s``
    lift of invariant I11);
  * runs **journaled cross-host request migration** on the
    extract/ship/admit path: the SOURCE host's manager journals the
    intent (``dst_host`` detail), the destination tenant is driven
    through a fabric-checked ``RemoteTenant`` proxy, and a partition
    mid-migration leaves a DEFERRED pending entry (frozen source slot,
    nothing served twice) that the first post-heal ``recover`` resolves
    exactly once — invariants I15/I16;
  * fences **stale coordinators with lease epochs**: every op carries
    the coordinator's epoch, hosts reject older epochs
    (``SplitBrainError``), and ``handoff`` mints epoch+1 so at most one
    coordinator can drive any host after a takeover.

All networking is modelled by ``Fabric`` — an in-process reachability
relation with armable one-shot fault windows, the network analogue of
``core.fault.crash_plane`` (the sim's network-fault catalogue lives in
``repro_torch.sim.federation.NETWORK_FAULTS``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Optional, Sequence

from repro_torch.core.autoscaler import (Autoscaler, AutoscaleAction,
                                         EngineStats, TelemetrySnapshot)
from repro_torch.core.errors import (FederationError, HostUnreachableError,
                                     LeaseExpiredError, SplitBrainError)
from repro_torch.core.host import Host
from repro_torch.core.scheduler import (AdmissionError, HostCandidate,
                                        choose_host)

#: rid-space stride between coordinator epochs: two coordinators that
#: both survive a handoff window can never mint the same request id
RID_STRIDE = 1_000_000_000


# ---------------------------------------------------------------------------
# network model
# ---------------------------------------------------------------------------
class Fabric:
    """In-process network: nodes (host ids + coordinator ids) are mutually
    reachable unless a partition splits them into groups. ``arm`` primes a
    one-shot fault window (named points inside coordinator paths); when
    the window executes, the armed partition strikes *at that instant* —
    the network analogue of ``crash_plane.arm``/``crashpoint``."""

    def __init__(self):
        self._groups: Optional[tuple] = None
        self._armed: Optional[tuple] = None     # (window, groups)
        self.fired: list[str] = []              # windows that struck
        self.partitions = 0

    # -- partitions ---------------------------------------------------------
    def partition(self, *groups: Iterable[str]) -> None:
        """Split the fabric: nodes within one group stay mutually
        reachable; nodes in different groups (or unlisted — they form one
        implicit residual group) cannot reach each other."""
        self._groups = tuple(frozenset(g) for g in groups)
        self.partitions += 1

    def heal(self) -> None:
        self._groups = None

    @property
    def partitioned(self) -> bool:
        return self._groups is not None

    def _group_of(self, node: str) -> int:
        for i, g in enumerate(self._groups):
            if node in g:
                return i
        return -1                               # implicit residual group

    def reachable(self, a: str, b: str) -> bool:
        if a == b or self._groups is None:
            return True
        return self._group_of(a) == self._group_of(b)

    def require(self, a: str, b: str) -> None:
        if not self.reachable(a, b):
            raise HostUnreachableError(
                f"{a} cannot reach {b} (fabric partitioned)")

    # -- fault windows ------------------------------------------------------
    def arm(self, window: str, *groups: Iterable[str]) -> None:
        """One-shot: when ``window`` next executes, install
        ``partition(*groups)`` at exactly that instant."""
        self._armed = (window, tuple(tuple(g) for g in groups))

    def disarm(self) -> None:
        self._armed = None

    def window(self, name: str) -> None:
        if self._armed is not None and self._armed[0] == name:
            _, groups = self._armed
            self._armed = None
            self.fired.append(name)
            self.partition(*groups)


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Lease:
    """One host's liveness grant: valid until ``expires_at`` on the
    COORDINATOR's clock, stamped with the granting epoch."""
    host_id: str
    epoch: int
    granted_at: float
    expires_at: float

    def valid(self, now: float) -> bool:
        return now < self.expires_at


# ---------------------------------------------------------------------------
# cross-host tenant proxy
# ---------------------------------------------------------------------------
class RemoteTenant:
    """Coordinator-side proxy making a tenant on ANOTHER host usable as
    the ``dst`` of ``SVFFManager.migrate_request``: every protocol call
    traverses the fabric (raising ``HostUnreachableError`` on a
    partition), and the two migration fault windows live here —
    ``fed_migrate_mid_ship`` strikes before the remote admit (rollback-
    shaped), ``fed_migrate_after_admit`` after it (roll-forward-shaped,
    the classic in-doubt distributed commit)."""

    def __init__(self, fabric: Fabric, src_host: str, dst_host: str,
                 tenant):
        self._fabric = fabric
        self._src = src_host
        self._dst = dst_host
        self._t = tenant

    def _require(self) -> None:
        self._fabric.require(self._src, self._dst)

    # identity/validation surface the manager reads
    @property
    def tid(self):
        return self._t.tid

    @property
    def status(self):
        return getattr(self._t, "status", None)

    @property
    def vf_id(self):
        return getattr(self._t, "vf_id", None)

    # migration protocol, fabric-checked
    def shardings_for(self, vf):
        """Where the shipped state lands: the wrapped tenant's own device
        (the source manager passes no VF — its pool holds none of this
        host's)."""
        self._require()
        return self._t.shardings_for(vf)

    def admit_migrated(self, payload, state):
        self._fabric.window("fed_migrate_mid_ship")
        self._require()
        out = self._t.admit_migrated(payload, state)
        self._fabric.window("fed_migrate_after_admit")
        self._require()                 # ack loss after the remote admit
        return out

    def owns_request(self, rid) -> bool:
        self._require()
        return self._t.owns_request(rid)

    def abort_incoming(self, rid):
        self._require()
        return self._t.abort_incoming(rid)


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------
class FederationCoordinator:
    """Lease-based fleet-of-fleets control plane over ``Host``s. All time
    comes from the injected ``clock``; all networking goes through the
    shared ``Fabric``; every host-facing op carries ``self.epoch`` so a
    superseded coordinator is fenced, not trusted."""

    def __init__(self, hosts: Sequence[Host], *, clock,
                 fabric: Optional[Fabric] = None,
                 policy: str = "first_fit",
                 lease_ttl: float = 3.0,
                 max_staleness: float = 2.0,
                 epoch: int = 1,
                 node_id: str = "fed0"):
        self.hosts: dict[str, Host] = {h.host_id: h for h in hosts}
        if len(self.hosts) != len(hosts):
            raise FederationError("duplicate host_id in federation")
        self.clock = clock
        self.fabric = fabric or Fabric()
        self.policy = policy
        self.lease_ttl = lease_ttl
        self.max_staleness = max_staleness
        self.epoch = epoch
        self.node_id = node_id
        self.leases: dict[str, Lease] = {}
        #: replicated, stamped telemetry (newest snapshot PULLED per host)
        self.snapshots: dict[str, dict] = {}
        #: routing ledger: rid -> host_id it was admitted to
        self.residency: dict[int, str] = {}
        #: admissions whose ack was lost to a partition: never re-routed
        #: until ``reconcile`` confirms them against the owner (I15)
        self.in_doubt: set[int] = set()
        #: optimistic per-host load routed since the last fresh snapshot
        self._routed: dict[str, int] = {}
        self._next_rid = 0
        self._obs_epoch = 0
        self.rejections = 0
        self.deferred_migrations = 0
        for h in hosts:
            self._wire(h)

    # ------------------------------------------------------------- plumbing
    def _wire(self, host: Host) -> None:
        host.mgr.peer_lookup = functools.partial(self._peer_tenant,
                                                 host.host_id)

    def _peer_tenant(self, from_host: str, to_host: str, tid: str):
        """Host-to-host tenant resolution for cross-host recovery — goes
        through the fabric (host A recovering a migrate toward host B
        needs A-B reachability, not coordinator involvement)."""
        self.fabric.require(from_host, to_host)
        peer = self.hosts.get(to_host)
        if peer is None:
            return None
        return (peer.mgr.tenants.get(tid)
                or peer.tenants.get(tid))

    def now(self) -> float:
        return self.clock.now()

    def mint_rid(self) -> int:
        """Epoch-salted request ids: coordinators that coexist across a
        handoff window can never mint the same rid."""
        rid = self.epoch * RID_STRIDE + self._next_rid
        self._next_rid += 1
        return rid

    # ------------------------------------------------------------- liveness
    def heartbeat_all(self) -> dict:
        """Renew every reachable host's lease and pull its telemetry
        snapshot; unreachable hosts keep their (aging) lease and stale
        snapshot — lapsing is what takes them out of routing. A host that
        fences this coordinator's epoch (post-handoff) loses its lease
        here instead of renewing it."""
        now = self.now()
        renewed, lost = [], []
        for hid in sorted(self.hosts):
            if not self.fabric.reachable(self.node_id, hid):
                continue
            host = self.hosts[hid]
            try:
                host.check_epoch(self.epoch)
            except SplitBrainError:
                self.leases.pop(hid, None)
                lost.append(hid)
                continue
            host.heartbeat()
            self.leases[hid] = Lease(hid, self.epoch, now,
                                     now + self.lease_ttl)
            self.snapshots[hid] = host.snapshot()
            self.snapshots[hid]["pulled_at"] = now
            self._routed[hid] = 0
            renewed.append(hid)
        return {"renewed": renewed, "fenced": lost, "t": now}

    def live_hosts(self) -> list[str]:
        now = self.now()
        return [hid for hid in sorted(self.hosts)
                if (lease := self.leases.get(hid)) is not None
                and lease.valid(now)]

    def _require_live(self, hid: str) -> None:
        lease = self.leases.get(hid)
        if lease is None or not lease.valid(self.now()):
            raise LeaseExpiredError(
                f"{hid}: no valid lease at t={self.now():.3f} "
                f"(expired {getattr(lease, 'expires_at', None)})")

    # ------------------------------------------------------------- routing
    def _candidates(self) -> list[HostCandidate]:
        """Routable hosts: valid lease AND replicated snapshot younger
        than the staleness bound; load = replicated load + optimistic
        count routed since that snapshot."""
        now = self.now()
        cands = []
        for hid in self.live_hosts():
            snap = self.snapshots.get(hid)
            if snap is None or now - snap["pulled_at"] > self.max_staleness:
                continue
            cands.append(HostCandidate(
                host_id=hid,
                load=int(snap["load"]) + self._routed.get(hid, 0),
                capacity=int(snap["capacity"])))
        return cands

    def submit(self, rid: Optional[int] = None,
               seed: Optional[int] = None) -> dict:
        """Admit ONE request to the fleet. Pre-admit failures (partition
        on delivery, fenced host, full host) re-route to the next
        candidate — safe, nothing was admitted. A partition AFTER the
        host admitted (ack loss) marks the rid in-doubt: it is recorded
        against that host and never re-routed, so the same request can
        never be served twice (I15)."""
        if rid is None:
            rid = self.mint_rid()
        if rid in self.residency or rid in self.in_doubt:
            raise FederationError(
                f"rid {rid} already admitted to "
                f"{self.residency.get(rid, '?')} (exactly-once admission)")
        last_err: Optional[Exception] = None
        tried = set()
        while True:
            cands = [c for c in self._candidates()
                     if c.host_id not in tried]
            try:
                cand = choose_host(self.policy, cands)
            except AdmissionError as e:
                self.rejections += 1
                raise (last_err or e)
            hid = cand.host_id
            tried.add(hid)
            host = self.hosts[hid]
            try:
                self.fabric.window("fed_submit_route")
                self.fabric.require(self.node_id, hid)
                host.submit(rid, epoch=self.epoch, seed=seed)
            except HostUnreachableError as e:
                last_err = e            # delivery failed: nothing admitted
                continue
            except SplitBrainError as e:
                self.leases.pop(hid, None)     # this host obeys a newer
                last_err = e                   # coordinator now
                continue
            except AdmissionError as e:
                last_err = e
                continue
            self.residency[rid] = hid
            self._routed[hid] = self._routed.get(hid, 0) + 1
            try:
                self.fabric.window("fed_submit_after_admit")
                self.fabric.require(self.node_id, hid)
            except HostUnreachableError:
                self.in_doubt.add(rid)
                return {"rid": rid, "host": hid, "in_doubt": True}
            return {"rid": rid, "host": hid, "in_doubt": False}

    def reconcile(self) -> dict:
        """Post-heal: resolve in-doubt admissions against the owner host
        (did the admit land before the ack was lost?) and drop residency
        entries whose admission turned out to have been lost."""
        confirmed, lost = [], []
        for rid in sorted(self.in_doubt):
            hid = self.residency.get(rid)
            if hid is None or not self.fabric.reachable(self.node_id, hid):
                continue
            if self.hosts[hid].owner_engine(rid) is not None:
                confirmed.append(rid)
            else:
                # a deferred migration that rolled FORWARD left the rid on
                # its destination: search the reachable fleet for the new
                # owner before declaring the admission lost
                moved = next(
                    (h2 for h2 in sorted(self.hosts) if h2 != hid
                     and self.fabric.reachable(self.node_id, h2)
                     and self.hosts[h2].owner_engine(rid) is not None),
                    None)
                if moved is not None:
                    self.residency[rid] = moved
                    confirmed.append(rid)
                else:
                    self.residency.pop(rid, None)
                    lost.append(rid)
            self.in_doubt.discard(rid)
        return {"confirmed": confirmed, "lost": lost}

    # ------------------------------------------------------------ migration
    def migrate_request(self, src_host: str, dst_host: str,
                        rid: Optional[int] = None,
                        src_tid: Optional[str] = None,
                        dst_tid: Optional[str] = None) -> dict:
        """Journaled cross-host request migration on the extract/ship/
        admit path. The SOURCE manager journals the intent with the
        ``dst_host`` detail and drives the destination through a
        ``RemoteTenant`` proxy; a partition mid-flight surfaces as
        ``HostUnreachableError``, the manager's clean-failure path consults ``peer_lookup``, finds the
        peer unreachable, and DEFERS the entry — the source slot stays
        frozen (served by no one) until a post-heal ``recover`` resolves
        it against the target-owns predicate exactly once."""
        self._require_live(src_host)
        self._require_live(dst_host)
        self.fabric.require(self.node_id, src_host)
        src = self.hosts[src_host]
        dst = self.hosts[dst_host]
        src.check_epoch(self.epoch)
        # pick the source engine: the one serving ``rid``, else the first
        # with any migratable in-flight request
        src_tn = None
        if src_tid is not None:
            src_tn = src.mgr.tenants.get(src_tid)
        elif rid is not None:
            src_tn = src.owner_engine(rid)
        else:
            for tn in src.serve_targets():
                if (hasattr(tn, "peek_migratable")
                        and tn.peek_migratable() is not None):
                    src_tn = tn
                    break
        if src_tn is None:
            raise FederationError(
                f"migrate_request: no source engine on {src_host} "
                f"for rid={rid}")
        # pick the destination engine: explicitly named, else least loaded
        if dst_tid is not None:
            dst_tn = dst.mgr.tenants.get(dst_tid)
        else:
            targets = [t for t in dst.serve_targets()
                       if hasattr(t, "admit_migrated")]
            dst_tn = min(targets, key=Host._engine_load, default=None)
        if dst_tn is None:
            raise FederationError(
                f"migrate_request: no target engine on {dst_host}")
        proxy = RemoteTenant(self.fabric, src_host, dst_host, dst_tn)
        try:
            out = src.mgr.migrate_request(src_tn, proxy, rid,
                                          dst_host=dst_host)
        except HostUnreachableError:
            self.deferred_migrations += 1
            if rid is not None:
                self.in_doubt.add(rid)
            raise
        moved = out["rid"]
        self.residency[moved] = dst_host
        self.in_doubt.discard(moved)
        out["src_host"], out["dst_host"] = src_host, dst_host
        return out

    # ------------------------------------------------------------ telemetry
    def fleet_snapshot(self) -> TelemetrySnapshot:
        """The autoscaler's view of the whole fleet, built ONLY from
        replicated snapshots. ``age_s`` is the oldest included snapshot's
        age on the coordinator's clock — the staleness bound
        (``AutoscaleConfig.max_staleness_s``) suppresses actions planned
        from evidence older than that (I11 lifted to the federation)."""
        now = self.now()
        self._obs_epoch += 1
        engines, age, free_vfs = [], 0.0, 0
        slo = 1
        for i, hid in enumerate(sorted(self.snapshots)):
            snap = self.snapshots[hid]
            age = max(age, now - snap["pulled_at"])
            free_vfs += int(snap.get("free_vfs", 0))
            slo = max(slo, int(snap.get("max_load", 1)))
            for j, (tid, e) in enumerate(sorted(snap["engines"].items())):
                engines.append(EngineStats(
                    tid=f"{hid}/{tid}", index=i * 1000 + j,
                    status="running", load=int(e["load"])))
        return TelemetrySnapshot(
            epoch=self._obs_epoch, slo_max_load=slo,
            engines=tuple(engines), free_vfs=free_vfs, age_s=age)

    def plan_autoscale(self, autoscaler: Autoscaler
                       ) -> Optional[AutoscaleAction]:
        """One observation epoch over the replicated fleet view; returns
        the (at most one) action, or None — including the None forced by
        the staleness bound when every snapshot is partition-aged."""
        return autoscaler.observe(self.fleet_snapshot())

    # ------------------------------------------------------------- recovery
    def recover(self, host_ids: Optional[Iterable[str]] = None) -> dict:
        """Federation recovery: rebuild each named host's manager from
        its survivable pieces (any subset, any order — I16 asserts the
        result fingerprint is order- and repetition-invariant), then
        reconcile in-doubt admissions. Deferred cross-host entries
        resolve here iff their peer is reachable; otherwise they stay
        deferred for the next recover."""
        recovered = []
        for hid in sorted(host_ids if host_ids is not None else self.hosts):
            host = self.hosts[hid]
            host.recover()
            self._wire(host)
            recovered.append(hid)
        rec = self.reconcile()
        return {"recovered": recovered, **rec}

    # -------------------------------------------------------------- handoff
    def handoff(self, node_id: Optional[str] = None
                ) -> "FederationCoordinator":
        """Coordinator failover: mint the successor at epoch+1. Its first
        ``heartbeat_all`` fences every host it can reach; this (now
        stale) coordinator keeps running — and gets ``SplitBrainError``
        from any fenced host it still tries to drive, which is exactly
        invariant I15's fencing clause."""
        succ = FederationCoordinator(
            list(self.hosts.values()), clock=self.clock,
            fabric=self.fabric, policy=self.policy,
            lease_ttl=self.lease_ttl, max_staleness=self.max_staleness,
            epoch=self.epoch + 1,
            node_id=node_id or f"fed{self.epoch + 1}")
        succ.residency = dict(self.residency)
        succ.in_doubt = set(self.in_doubt)
        succ._next_rid = self._next_rid
        succ.snapshots = {hid: dict(s) for hid, s in self.snapshots.items()}
        succ.heartbeat_all()
        return succ

    def describe(self) -> dict:
        return {"node_id": self.node_id, "epoch": self.epoch,
                "policy": self.policy, "hosts": sorted(self.hosts),
                "live": self.live_hosts(),
                "leases": {h: dataclasses.asdict(l)
                           for h, l in self.leases.items()},
                "in_doubt": sorted(self.in_doubt),
                "deferred_migrations": self.deferred_migrations,
                "rejections": self.rejections}


__all__ = ["Fabric", "FederationCoordinator", "Lease", "RemoteTenant",
           "RID_STRIDE"]
