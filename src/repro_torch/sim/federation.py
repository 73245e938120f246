"""Federation scenario plane — multi-host scenarios + network-fault chaos
(mirrors ``repro.sim.federation``).

The single-host scenario machinery (``scenario``/``harness``/``chaos``)
proves that ONE manager survives arbitrary op histories and process
crashes. This module lifts that to a FEDERATION: several ``Host``s (each
a full manager + journal + pool + serving tenants) behind a
``FederationCoordinator``, with the network itself as the fault plane —
partitions instead of process crashes, lease lapses instead of device
failures, stale coordinators instead of stale snapshots.

Three public surfaces, mirroring the single-host trio:

  * ``FedScenarioConfig`` / ``generate_fed_scenario`` — seeded generator
    over federation ops (``FED_OP_KINDS``). Every fault knob defaults to
    0, so a pre-fault config draws a byte-identical op stream.
  * ``FedRunner`` / ``run_fed_scenario`` — executes a scenario against
    real hosts, asserting per-host invariants (I1-I14 via
    ``check_invariants``) AND the federation invariants (I15 via
    ``check_federation``) after every op; ``host_crash`` ops additionally
    assert I16 (double ``recover`` is a ``federation_fingerprint``
    no-op).
  * ``NETWORK_FAULTS`` / ``run_network_fault_case`` /
    ``network_fault_matrix`` — the network-fault analogue of
    ``chaos.CRASH_POINTS``: each catalogued window arms a one-shot
    partition at a named instant inside a coordinator path
    (``Fabric.arm``), and the per-cell runner asserts the catalogued
    outcome, I15/I16, and end-to-end token-oracle fidelity (I10) for
    every request the fault touched.

Every entry point that builds sim tenants takes ``device`` (the card by
default) and places each ``SimServeTenant``'s state there; the checks
after every op also hold that every running tenant's state leaves are
tensors on that device.

Op kinds (``FedOp.kind``):

  init        build the fleet: ``num_hosts`` hosts x 2 serving engines
              (3 VFs each: one spare stays detached so autoscale
              snapshots see real ``free_vfs``), coordinator heartbeats
  submit      admit ``n`` requests through coordinator routing
              (``choose_host`` over replicated snapshots); typed
              rejections (no live host, every engine full) are clean
  step        every host's running engines advance ``steps`` iterations
  beat        advance the virtual clock by ``dt`` and run one lease
              heartbeat round (renews reachable hosts, pulls snapshots)
  migrate     cross-host journaled request migration ``host -> dst``
              (picks the first migratable in-flight request; partitions
              mid-op DEFER the journal entry — resolved post-heal)
  partition   isolate ``host`` from the rest of the fabric (the
              coordinator stays with the majority side)
  heal        heal the fabric, heartbeat, and run federation recovery
              (resolves deferred cross-host entries, reconciles
              in-doubt admissions)
  host_crash  kill+rebuild ``host``'s manager from its journal (the
              single-host recovery path under federation wiring), then
              assert I16: a second recovery is fingerprint-identical
  handoff     coordinator failover: successor at epoch+1 fences every
              reachable host; the old coordinator's object stays live
              (split-brain fencing is ITS problem now)
  autoscale   one fleet-wide policy epoch over replicated telemetry;
              any planned action must be justified by its snapshot
              (I11), and a snapshot older than the staleness bound
              plans nothing
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import tempfile
import zlib
from typing import Iterable, Optional, Sequence

from repro_torch.core.autoscaler import Autoscaler, AutoscaleConfig
from repro_torch.core.errors import (FederationError, HostUnreachableError,
                                     LeaseExpiredError, SplitBrainError)
from repro_torch.core.federation import Fabric, FederationCoordinator
from repro_torch.core.host import Host
from repro_torch.core.scheduler import AdmissionError
from repro_torch.device import resolve_device
from repro_torch.serve.paged import CacheExhausted
from repro_torch.sim.chaos import state_fingerprint
from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.invariants import (InvariantViolation, _serving_map,
                                        check_autoscale, check_federation,
                                        check_invariants, check_placement)
from repro_torch.sim.tenant import SimServeTenant

FED_OP_KINDS = ("init", "submit", "step", "beat", "migrate", "partition",
                "heal", "host_crash", "handoff", "autoscale")

#: lease/staleness parameters every fed cell runs with (virtual seconds)
LEASE_TTL = 3.0
MAX_STALENESS = 2.0


@dataclasses.dataclass(frozen=True)
class FedOp:
    kind: str
    host: Optional[str] = None      # acting host (partition victim, ...)
    dst: Optional[str] = None       # migrate only: destination host
    steps: int = 1                  # step only
    n: int = 1                      # submit only: batch size
    dt: float = 0.0                 # beat only: virtual seconds to advance

    def __post_init__(self):
        assert self.kind in FED_OP_KINDS, self.kind


@dataclasses.dataclass(frozen=True)
class FedScenarioConfig:
    seed: int = 0
    num_ops: int = 40
    num_hosts: int = 3
    policy: str = "first_fit"
    #: every fault knob defaults to 0 — a pre-fault config generates a
    #: byte-identical op stream (the sim plane's compatibility rule)
    partition_rate: float = 0.0
    crash_rate: float = 0.0
    handoff_rate: float = 0.0
    migrate_rate: float = 0.0
    autoscale_rate: float = 0.0


def generate_fed_scenario(cfg: FedScenarioConfig) -> tuple:
    """Seeded federation op stream; same config -> identical tuple. The
    validity model is one bit — partitioned or not — because every
    federation op is DEFINED to be clean under partition (typed
    rejection, deferred entry, or aged lease), which is the property
    under test."""
    rng = random.Random(0xFED ^ (cfg.seed * 2654435761 % 2**31))
    hid = lambda i: f"h{i}"                                  # noqa: E731
    ops: list[FedOp] = [FedOp("init")]
    partitioned = False
    while len(ops) < cfg.num_ops:
        if partitioned and rng.random() < 0.35:
            ops.append(FedOp("heal"))
            partitioned = False
            continue
        if (cfg.partition_rate and not partitioned
                and rng.random() < cfg.partition_rate):
            ops.append(FedOp("partition",
                             host=hid(rng.randrange(cfg.num_hosts))))
            partitioned = True
            continue
        if cfg.crash_rate and rng.random() < cfg.crash_rate:
            ops.append(FedOp("host_crash",
                             host=hid(rng.randrange(cfg.num_hosts))))
            continue
        if (cfg.handoff_rate and not partitioned
                and rng.random() < cfg.handoff_rate):
            ops.append(FedOp("handoff"))
            continue
        if cfg.migrate_rate and rng.random() < cfg.migrate_rate:
            s = rng.randrange(cfg.num_hosts)
            d = (s + 1 + rng.randrange(cfg.num_hosts - 1)) % cfg.num_hosts
            ops.append(FedOp("migrate", host=hid(s), dst=hid(d)))
            continue
        if cfg.autoscale_rate and rng.random() < cfg.autoscale_rate:
            ops.append(FedOp("autoscale"))
            continue
        r = rng.random()
        if r < 0.35:
            ops.append(FedOp("submit", n=rng.choice([1, 1, 2, 3])))
        elif r < 0.80:
            ops.append(FedOp("step", steps=rng.randint(1, 3)))
        else:
            ops.append(FedOp("beat", dt=round(rng.uniform(0.2, 1.2), 3)))
    if partitioned:
        ops.append(FedOp("heal"))        # scenarios end quiescent
    return tuple(ops)


def federation_fingerprint(hosts: Sequence[Host],
                           coordinator: Optional[FederationCoordinator]
                           = None) -> str:
    """Deterministic digest of everything federation recovery touches:
    per-host management-plane fingerprints (pool/tenants/records/journal
    resolutions), epoch fences, the serving/frozen request maps, and the
    coordinator's routing ledger. I16 asserts a double ``recover`` over
    any host subset leaves this unchanged."""
    per_host = []
    for h in sorted(hosts, key=lambda h: h.host_id):
        serving, frozen = _serving_map(h)
        per_host.append([h.host_id, state_fingerprint(h.mgr),
                         h.fence_epoch,
                         sorted(serving.items()),
                         sorted(frozen.items())])
    coord = None
    if coordinator is not None:
        coord = [coordinator.node_id, coordinator.epoch,
                 sorted(coordinator.residency.items()),
                 sorted(coordinator.in_doubt)]
    blob = json.dumps([per_host, coord], sort_keys=True, default=str)
    return f"{zlib.crc32(blob.encode()):08x}"


# ---------------------------------------------------------------------------
# cell builder (shared by the scenario runner and the fault matrix)
# ---------------------------------------------------------------------------
def build_fed_cell(seed: int, *, num_hosts: int = 3,
                   policy: str = "first_fit",
                   workdir: str, device="cuda") -> dict:
    """Deterministic small federation: ``num_hosts`` hosts x 2
    ``SimServeTenant`` engines each (state on ``device``), over 3 VFs (the
    third stays detached with devices, so replicated snapshots carry a
    real ``free_vfs`` for the autoscale paths), one shared
    ``VirtualClock`` + ``Fabric``, a coordinator with every lease freshly
    granted."""
    device = resolve_device(device)
    clock = VirtualClock()
    fabric = Fabric()
    hosts = []
    for i in range(num_hosts):
        hid = f"h{i}"
        host = Host(hid, workdir=os.path.join(workdir, hid), clock=clock,
                    num_devices=8, max_vfs=4, policy=policy,
                    lease_ttl=LEASE_TTL, max_load_per_engine=6)
        svs = [SimServeTenant(f"{hid}.sv{j}", seed=seed * 31 + i * 7 + j,
                              clock=clock, placement=policy, device=device)
               for j in range(2)]
        host.mgr.init(num_vfs=3, tenants=svs, devices_per_vf=2)
        host.adopt({tn.tid: tn for tn in svs})
        hosts.append(host)
    coord = FederationCoordinator(hosts, clock=clock, fabric=fabric,
                                  policy=policy, lease_ttl=LEASE_TTL,
                                  max_staleness=MAX_STALENESS)
    coord.heartbeat_all()
    return {"clock": clock, "fabric": fabric, "hosts": hosts,
            "coordinator": coord, "device": device}


# ---------------------------------------------------------------------------
# scenario runner
# ---------------------------------------------------------------------------
class FedRunner:
    """Execute one federation scenario, asserting I1-I15 after every op
    (and I16 on every host_crash). Mirrors ``harness.ScenarioRunner``:
    per-op outcome rows, violations tagged ``seed=<s> op#<i>``."""

    def __init__(self, cfg: FedScenarioConfig,
                 workdir: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        self.rows: list[dict] = []

    def run(self) -> dict:
        cfg = self.cfg
        wd = self.workdir or tempfile.mkdtemp(prefix="svff_fed_")
        ops = generate_fed_scenario(cfg)
        try:
            cell = build_fed_cell(cfg.seed, num_hosts=cfg.num_hosts,
                                  policy=cfg.policy, workdir=wd,
                                  device=self.device)
            self.clock = cell["clock"]
            self.fabric = cell["fabric"]
            self.hosts = cell["hosts"]
            self.coordinator = cell["coordinator"]
            self.old_coordinators: list[FederationCoordinator] = []
            self.autoscaler = Autoscaler(AutoscaleConfig(
                hysteresis=1, cooldown=2,
                max_staleness_s=MAX_STALENESS))
            self.submitted = self.rejected = self.deferred = 0
            for i, op in enumerate(ops):
                try:
                    status = self._apply(op)
                    self._check()
                except InvariantViolation as e:
                    raise InvariantViolation(
                        f"fed scenario seed={cfg.seed} "
                        f"policy={cfg.policy} op#{i} {op.kind}: {e}"
                        ) from e
                self.rows.append({"i": i, "kind": op.kind,
                                  "status": status})
            return {"seed": cfg.seed, "ops": len(ops),
                    "submitted": self.submitted,
                    "rejected": self.rejected,
                    "deferred": self.deferred,
                    "epoch": self.coordinator.epoch,
                    "fingerprint": federation_fingerprint(
                        self.hosts, self.coordinator),
                    "rows": self.rows}
        finally:
            if self.workdir is None:
                shutil.rmtree(wd, ignore_errors=True)

    # ------------------------------------------------------------------
    def _apply(self, op: FedOp) -> str:
        co = self.coordinator
        if op.kind == "init":
            return "ok"
        if op.kind == "submit":
            ok = 0
            for _ in range(op.n):
                try:
                    co.submit(seed=self.cfg.seed * 17 + 5)
                    ok += 1
                    self.submitted += 1
                except (AdmissionError, LeaseExpiredError,
                        FederationError):
                    self.rejected += 1
            return f"admitted {ok}/{op.n}"
        if op.kind == "step":
            for host in self.hosts:
                for tn in host.serve_targets():
                    tn.run_steps(op.steps)
            return "ok"
        if op.kind == "beat":
            self.clock.advance(op.dt)
            beat = co.heartbeat_all()
            return f"renewed {len(beat['renewed'])}"
        if op.kind == "migrate":
            src = next(h for h in self.hosts if h.host_id == op.host)
            rid = None
            for tn in src.serve_targets():
                rid = tn.peek_migratable()
                if rid is not None:
                    break
            if rid is None:
                return "no-op (nothing migratable)"
            try:
                co.migrate_request(op.host, op.dst, rid)
                return f"moved {rid}"
            except HostUnreachableError:
                self.deferred += 1
                return f"deferred {rid}"
            except (LeaseExpiredError, SplitBrainError, FederationError,
                    AdmissionError, CacheExhausted) as e:
                return f"clean reject ({type(e).__name__})"
        if op.kind == "partition":
            rest = [h.host_id for h in self.hosts
                    if h.host_id != op.host]
            coords = [co.node_id] + [c.node_id
                                     for c in self.old_coordinators]
            self.fabric.partition(coords + rest, [op.host])
            return f"isolated {op.host}"
        if op.kind == "heal":
            self.fabric.heal()
            co.heartbeat_all()
            rec = co.recover()          # resolve deferred + reconcile
            return f"healed (+{len(rec['confirmed'])} confirmed)"
        if op.kind == "host_crash":
            co.recover([op.host])
            fp1 = federation_fingerprint(self.hosts, co)
            co.recover([op.host])
            fp2 = federation_fingerprint(self.hosts, co)
            if fp1 != fp2:
                raise InvariantViolation(
                    f"I16 federation recovery of {op.host} not "
                    f"idempotent: {fp1} != {fp2}")
            return f"recovered {op.host}"
        if op.kind == "handoff":
            self.old_coordinators.append(co)
            self.coordinator = co.handoff()
            return f"epoch {self.coordinator.epoch}"
        if op.kind == "autoscale":
            action = co.plan_autoscale(self.autoscaler)
            if action is not None:
                check_autoscale(action, self.autoscaler.cfg)
                return f"planned {action.kind}"
            return "quiet"
        raise ValueError(f"unknown fed op {op.kind!r}")

    def _check(self) -> None:
        for host in self.hosts:
            check_invariants(host.mgr)
        check_federation(self.hosts,
                         [self.coordinator] + self.old_coordinators)
        check_placement([tn for h in self.hosts for tn in h.serve_targets()],
                        self.device)


def run_fed_scenario(cfg: FedScenarioConfig,
                     workdir: Optional[str] = None, device="cuda") -> dict:
    return FedRunner(cfg, workdir=workdir, device=device).run()


# ---------------------------------------------------------------------------
# network-fault catalogue (the partition analogue of chaos.CRASH_POINTS)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NetFaultSpec:
    window: str
    outcome: str                    # catalogued recovery semantics
    doc: str


NETWORK_FAULTS: dict[str, NetFaultSpec] = {s.window: s for s in (
    NetFaultSpec("partition_leases", "route_around",
                 "a host is isolated until its lease lapses: routing "
                 "excludes it (LeaseExpiredError on direct ops), traffic "
                 "flows through the survivors, and a heal + heartbeat "
                 "restores it without losing a request"),
    NetFaultSpec("fed_submit_route", "reroute",
                 "partition strikes between host choice and delivery — "
                 "nothing was admitted, the coordinator re-routes the "
                 "SAME rid to the next candidate; exactly one host "
                 "serves it"),
    NetFaultSpec("fed_submit_after_admit", "in_doubt_confirm",
                 "partition eats the admit ACK — the rid is recorded "
                 "in-doubt against its host and never re-routed (I15); "
                 "post-heal reconciliation confirms the single owner"),
    NetFaultSpec("fed_migrate_mid_ship", "defer_rollback",
                 "partition mid-ship, before the remote admit: recovery "
                 "DEFERS the journaled entry (source slot frozen, served "
                 "by nobody); the first post-heal recover rolls it back "
                 "— the request resumes on the source, token-identical"),
    NetFaultSpec("fed_migrate_after_admit", "defer_forward",
                 "partition after the remote admit (in-doubt distributed "
                 "commit): the entry defers with the destination already "
                 "serving; post-heal recover finds the target owns the "
                 "rid and rolls FORWARD — source copy released exactly "
                 "once (the partition-during-migrate regression)"),
    NetFaultSpec("lease_handoff", "fence_stale",
                 "coordinator failover during a partition that isolates "
                 "the OLD coordinator: the successor (epoch+1) fences "
                 "every host; the stale coordinator's admissions are "
                 "rejected (SplitBrainError) even after the heal, and "
                 "epoch-salted rid spaces can never collide"),
    NetFaultSpec("stale_telemetry_autoscale", "suppress",
                 "partition ages every replicated snapshot past the "
                 "staleness bound: the autoscaler plans NOTHING from "
                 "stale evidence (and freezes its streaks); one fresh "
                 "post-heal heartbeat re-enables justified actions"),
)}


def _drain_all(hosts: Sequence[Host], rounds: int = 60) -> None:
    for _ in range(rounds):
        busy = 0
        for host in hosts:
            for tn in host.serve_targets():
                tn.run_steps(1)
                busy += (len(tn.queue)
                         + sum(r is not None for r in tn.active))
        if busy == 0:
            return


def _oracle_check(hosts: Sequence[Host]) -> int:
    """I10 across the federation: every request any engine has emitted
    tokens for matches its no-fault oracle. Returns requests checked."""
    n = 0
    for host in hosts:
        for tn in host.serve_targets():
            for req in getattr(tn, "requests", ()):
                want = SimServeTenant.expected_output(req.seed, req.rid)
                got = list(req.out)
                if req.done and got != want:
                    raise InvariantViolation(
                        f"I10 {host.host_id}/{tn.tid} rid={req.rid}: "
                        f"{got} != oracle {want}")
                if not req.done and got != want[:len(got)]:
                    raise InvariantViolation(
                        f"I10 {host.host_id}/{tn.tid} rid={req.rid}: "
                        f"in-flight prefix {got} diverged from "
                        f"{want[:len(got)]}")
                n += 1
    return n


def _recover_idempotent(cell: dict,
                        host_ids: Optional[Iterable[str]] = None) -> None:
    """Post-heal federation recovery + the I16 assertion: a second
    recover over the same subset is a fingerprint no-op."""
    co = cell["coordinator"]
    co.recover(host_ids)
    fp1 = federation_fingerprint(cell["hosts"], co)
    co.recover(host_ids)
    fp2 = federation_fingerprint(cell["hosts"], co)
    if fp1 != fp2:
        raise InvariantViolation(
            f"I16 federation recovery not idempotent: {fp1} != {fp2}")


def _fed_checks(cell: dict, extra_coords=()) -> None:
    for host in cell["hosts"]:
        check_invariants(host.mgr)
    check_federation(cell["hosts"],
                     [cell["coordinator"], *extra_coords])
    check_placement([tn for h in cell["hosts"] for tn in h.serve_targets()],
                    cell["device"])


def run_network_fault_case(window: str, seed: int,
                           policy: str = "first_fit",
                           workdir: Optional[str] = None,
                           device="cuda") -> dict:
    """One cell of the network-fault matrix: build a 3-host federation,
    drive it into the catalogued window with a one-shot armed partition,
    and assert the catalogued outcome + I15 (during the fault) + I16
    (recovery idempotence after the heal) + I10 (every touched request
    finishes token-identical to its oracle)."""
    spec = NETWORK_FAULTS[window]
    wd = workdir or tempfile.mkdtemp(prefix="svff_netfault_")
    try:
        cell = build_fed_cell(seed, num_hosts=3, policy=policy,
                              workdir=wd, device=device)
        clock, fabric = cell["clock"], cell["fabric"]
        hosts, co = cell["hosts"], cell["coordinator"]
        by_id = {h.host_id: h for h in hosts}
        majority = [co.node_id, "h1", "h2"]
        extra_coords: list = []

        if window == "partition_leases":
            r0 = co.submit(seed=seed)
            fabric.partition(majority, ["h0"])
            clock.advance(LEASE_TTL + 0.1)
            co.heartbeat_all()
            if "h0" in co.live_hosts():
                raise InvariantViolation(
                    "isolated h0 still holds a valid lease after TTL")
            try:
                co.migrate_request("h0", "h1")
                raise InvariantViolation(
                    "direct op on lease-lapsed host not rejected")
            except LeaseExpiredError:
                pass
            routed = [co.submit(seed=seed) for _ in range(4)]
            if any(r["host"] == "h0" for r in routed):
                raise InvariantViolation(
                    "routing placed a request on a lease-lapsed host")
            _fed_checks(cell)
            fabric.heal()
            co.heartbeat_all()
            if "h0" not in co.live_hosts():
                raise InvariantViolation("healed h0 did not rejoin")
            if not any(c.host_id == "h0" for c in co._candidates()):
                raise InvariantViolation(
                    "healed h0 not back in the routing candidate set")
            if co.hosts["h0"].owner_engine(r0["rid"]) is None:
                raise InvariantViolation(
                    f"pre-partition request {r0['rid']} lost on h0")

        elif window == "fed_submit_route":
            # first_fit over equal loads picks h0 — cut exactly it at
            # the routing instant; delivery fails pre-admit, the SAME
            # rid re-routes to h1
            fabric.arm("fed_submit_route", majority, ["h0"])
            res = co.submit(seed=seed)
            if fabric.fired != ["fed_submit_route"]:
                raise InvariantViolation(
                    f"window never fired: {fabric.fired}")
            if res["host"] == "h0" or res["in_doubt"]:
                raise InvariantViolation(
                    f"re-route outcome wrong: {res}")
            owners = [h.host_id for h in hosts
                      if h.owner_engine(res["rid"]) is not None]
            if owners != [res["host"]]:
                raise InvariantViolation(
                    f"rid {res['rid']} owned by {owners}, "
                    f"routed to {res['host']}")
            _fed_checks(cell)
            fabric.heal()

        elif window == "fed_submit_after_admit":
            fabric.arm("fed_submit_after_admit", majority, ["h0"])
            res = co.submit(seed=seed)
            if not res["in_doubt"] or res["host"] != "h0":
                raise InvariantViolation(
                    f"ack-loss outcome wrong: {res}")
            owners = [h.host_id for h in hosts
                      if h.owner_engine(res["rid"]) is not None]
            if owners != ["h0"]:
                raise InvariantViolation(
                    f"in-doubt rid {res['rid']} owned by {owners}")
            try:
                co.submit(rid=res["rid"], seed=seed)
                raise InvariantViolation(
                    "in-doubt rid re-admitted (exactly-once broken)")
            except FederationError:
                pass
            _fed_checks(cell)
            fabric.heal()
            rec = co.reconcile()
            if rec["confirmed"] != [res["rid"]] or co.in_doubt:
                raise InvariantViolation(
                    f"reconcile outcome wrong: {rec}, "
                    f"in_doubt={co.in_doubt}")

        elif window in ("fed_migrate_mid_ship", "fed_migrate_after_admit"):
            # admit a small batch and pick the request with the longest
            # oracle (max_new >= 3 exists in any 3 consecutive rids), so
            # it is still mid-decode after one engine step — a request
            # that finishes at prefill is never migratable
            subs = [co.submit(seed=seed) for _ in range(3)]
            res = max(subs, key=lambda r: SimServeTenant.make_max_new(
                seed, r["rid"]))
            src = by_id[res["host"]]
            dst_id = "h1" if res["host"] != "h1" else "h2"
            for tn in src.serve_targets():
                tn.run_steps(1)
            eng = src.owner_engine(res["rid"])
            if eng is None or eng.peek_migratable(res["rid"]) is None:
                raise InvariantViolation(
                    f"setup: rid {res['rid']} not in a decoding slot on "
                    f"{src.host_id}")
            rest = [co.node_id] + [h.host_id for h in hosts
                                   if h.host_id != dst_id]
            fabric.arm(window, rest, [dst_id])
            try:
                co.migrate_request(src.host_id, dst_id, res["rid"])
                raise InvariantViolation(
                    f"window {window} never interrupted the migration")
            except HostUnreachableError:
                pass
            if fabric.fired != [window]:
                raise InvariantViolation(
                    f"window never fired: {fabric.fired}")
            deferred = [e for e in src.mgr.journal.pending()
                        if e["details"].get("deferred_cross_host")]
            if (len(deferred) != 1
                    or deferred[0]["details"].get("rid") != res["rid"]):
                raise InvariantViolation(
                    f"no deferred journal entry for rid {res['rid']}: "
                    f"{deferred}")
            if res["rid"] not in getattr(eng, "_migrating", {}):
                raise InvariantViolation(
                    "source slot not frozen under the deferred entry")
            dst_owns = by_id[dst_id].owner_engine(res["rid"]) is not None
            want_dst = window == "fed_migrate_after_admit"
            if dst_owns != want_dst:
                raise InvariantViolation(
                    f"{window}: destination owns={dst_owns}, "
                    f"catalogue says {want_dst}")
            _fed_checks(cell)               # I15 with the frozen slot
            fabric.heal()
            _recover_idempotent(cell, [src.host_id])
            owner = dst_id if want_dst else src.host_id
            owners = [h.host_id for h in hosts
                      if h.owner_engine(res["rid"]) is not None]
            if owners != [owner]:
                raise InvariantViolation(
                    f"post-heal owner {owners}, catalogue says "
                    f"[{owner}] ({spec.outcome})")
            if src.mgr.journal.pending():
                raise InvariantViolation(
                    "deferred entry survived the post-heal recover")
            if getattr(eng, "_migrating", None):
                raise InvariantViolation(
                    f"frozen slot survived recovery: {eng._migrating}")

        elif window == "lease_handoff":
            r_old = co.submit(seed=seed)
            # isolate the OLD coordinator; its successor lives with the
            # hosts (failover happens on the majority side)
            succ_id = f"fed{co.epoch + 1}"
            fabric.partition([co.node_id],
                             [succ_id] + [h.host_id for h in hosts])
            succ = co.handoff(succ_id)
            extra_coords.append(co)
            cell["coordinator"] = succ
            if any(h.fence_epoch != succ.epoch for h in hosts):
                raise InvariantViolation(
                    f"successor did not fence every host: "
                    f"{[(h.host_id, h.fence_epoch) for h in hosts]}")
            try:
                co.submit(seed=seed)
                raise InvariantViolation(
                    "isolated stale coordinator still admitted")
            except (AdmissionError, HostUnreachableError,
                    LeaseExpiredError):
                pass
            fabric.heal()
            clock.advance(0.1)
            try:
                co.submit(seed=seed)
                raise InvariantViolation(
                    "fenced stale coordinator admitted after heal")
            except (AdmissionError, SplitBrainError):
                pass
            r_new = succ.submit(seed=seed)
            if r_new["rid"] == r_old["rid"]:
                raise InvariantViolation(
                    "epoch-salted rid spaces collided across handoff")
            _fed_checks(cell, extra_coords)

        elif window == "stale_telemetry_autoscale":
            scaler = Autoscaler(AutoscaleConfig(
                hysteresis=1, cooldown=0,
                max_staleness_s=MAX_STALENESS))
            for _ in range(10):              # make h0's engines hot
                try:
                    co.submit(seed=seed)
                except AdmissionError:
                    break
            fabric.partition([co.node_id], [h.host_id for h in hosts])
            clock.advance(MAX_STALENESS + 0.5)
            stale = co.plan_autoscale(scaler)
            if stale is not None:
                raise InvariantViolation(
                    f"autoscale acted on stale telemetry: {stale}")
            snap = co.fleet_snapshot()
            if snap.age_s <= MAX_STALENESS:
                raise InvariantViolation(
                    f"stale snapshot age {snap.age_s} not past the "
                    f"bound {MAX_STALENESS}")
            fabric.heal()
            co.heartbeat_all()
            fresh = co.plan_autoscale(scaler)
            if fresh is not None:
                check_autoscale(fresh, scaler.cfg)   # I11 on fresh action
            if co.fleet_snapshot().age_s > MAX_STALENESS:
                raise InvariantViolation(
                    "post-heal snapshot still stale after heartbeat")

        else:
            raise ValueError(f"unknown network fault window {window!r}")

        # common epilogue: the federation quiesces clean — every touched
        # request completes token-identical to its oracle (I10), all
        # invariants green, recovery idempotent (I16)
        co = cell["coordinator"]
        co.heartbeat_all()
        _recover_idempotent(cell)
        _drain_all(hosts)
        checked = _oracle_check(hosts)
        _fed_checks(cell, extra_coords)
        return {"window": window, "seed": seed, "policy": policy,
                "outcome": spec.outcome, "oracle_checked": checked,
                "ok": True}
    except InvariantViolation as e:
        raise InvariantViolation(
            f"network fault window={window} seed={seed} "
            f"policy={policy}: {e}") from e
    finally:
        if workdir is None:
            shutil.rmtree(wd, ignore_errors=True)


def network_fault_matrix(windows: Optional[Iterable[str]] = None,
                         seeds: Sequence[int] = tuple(range(10)),
                         policies: Sequence[str] = ("first_fit",),
                         raise_on_fail: bool = True,
                         device="cuda") -> dict:
    """The network-fault matrix: windows x seeds x policies (the
    partition analogue of ``chaos.crash_matrix``); the chaos-marked test
    runs seeds 0-4, ``chip_smoke.py`` every window x seeds 0-9 x the
    three policies on the card."""
    windows = list(windows) if windows is not None else \
        list(NETWORK_FAULTS)
    cases, failures = [], []
    for window in windows:
        for policy in policies:
            for seed in seeds:
                try:
                    cases.append(run_network_fault_case(
                        window, seed, policy, device=device))
                except Exception as e:
                    if raise_on_fail:
                        raise
                    failures.append({"window": window, "seed": seed,
                                     "policy": policy, "error": repr(e)})
    return {"cases": cases, "failures": failures,
            "summary": {"windows": len(windows),
                        "seeds": len(list(seeds)),
                        "policies": list(policies),
                        "num_cases": len(cases) + len(failures),
                        "num_failures": len(failures)}}


__all__ = ["FED_OP_KINDS", "FedOp", "FedRunner", "FedScenarioConfig",
           "NETWORK_FAULTS", "NetFaultSpec", "build_fed_cell",
           "federation_fingerprint", "generate_fed_scenario",
           "network_fault_matrix", "run_fed_scenario",
           "run_network_fault_case"]
