"""Chaos harness — crash-inject the manager, recover it, prove invariants
(mirrors ``repro.sim.chaos``).

The paper's claim is that reconfiguration is transparent to guests; this
module sharpens it to *crash-transparent*: the management plane may die at
any of the named crash windows below and ``SVFFManager.recover`` must
rebuild an invariant-clean manager from what survives (journal + records
on disk, the device pool, the guests, the host-RAM snapshot table).

``CRASH_POINTS`` is the catalogue. Each spec names the ops that can reach
the window (``triggers``) and the recovery semantics the window commits
the stack to:

  outcome="none"      the op's destructive step had not run — recovery
                      rolls it BACK; guest state is as if the op was
                      never issued
  outcome="complete"  the destructive step ran (suspend / unbind / VF
                      re-attach) — recovery rolls it FORWARD; guest state
                      is as if the op fully succeeded

``run_crash_case(point, seed, policy)`` is the unit of the crash matrix:
build a deterministic small system, drive it to where the trigger op is
legal, arm the crash plane, catch the ``InjectedCrash``, recover — then
assert invariants I1-I8, recovery idempotence (I9: a second ``recover``
is a bit-identical no-op), the cataloged outcome, and post-recovery
liveness (the survivors still pause/unpause/step with bit-identical
state). ``crash_matrix`` sweeps points x seeds x policies and
``repro_torch.bench.crash_matrix`` writes the JSON report.

The catalogue holds the 19 points of the JAX package, and the port
recovers all of them (``PORTED_POINTS``): the 11 windows of the core ops,
the four of request migration (``migrate_*``) and the four of the gang
ops (``gang_*``, ``reshape_*``), whose cells run a pipeline gang lead
with its shells and check I14 and the gang's width per cell. The sim
tenants live on ``device`` (the card by default).
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import tempfile
import zlib
from typing import Iterable, Optional, Sequence

from repro_torch.core.fault import InjectedCrash, crash_plane
from repro_torch.core.journal import COMPLETED_STATUS as _COMPLETED_STATUS
from repro_torch.core.manager import SVFFManager
from repro_torch.core.pool import DevicePool
from repro_torch.core.qmp import ControlPlane
from repro_torch.core.staging import StagingEngine
from repro_torch.device import resolve_device
from repro_torch.sim.clock import VirtualClock
from repro_torch.sim.invariants import InvariantViolation, check_invariants
from repro_torch.sim.tenant import (SimPipelineTenant, SimServeTenant,
                                    SimTenant)


@dataclasses.dataclass(frozen=True)
class CrashSpec:
    point: str
    triggers: tuple                 # op kinds that can reach this window
    outcome: str                    # "none" (rollback) | "complete"
    doc: str


CRASH_POINTS: dict[str, CrashSpec] = {s.point: s for s in (
    CrashSpec("mid_record_write", ("attach",), "complete",
              "record .part staged but not renamed; bind already done"),
    CrashSpec("after_record_write", ("attach",), "complete",
              "record durable, WAL commit lost"),
    CrashSpec("mid_pipeline_chunk", ("pause", "pause_live", "detach"),
              "none",
              "staging descriptors partly across the link; snapshot "
              "unpublished, memo untouched (transactional save)"),
    CrashSpec("mid_precopy_round", ("pause_live",), "none",
              "a pre-copy round landed in the memo; guest untouched"),
    CrashSpec("after_snapshot_register", ("pause", "pause_live"), "none",
              "snapshot in host RAM, guest not yet suspended"),
    CrashSpec("after_suspend", ("pause", "pause_live"), "complete",
              "guest suspended; snapshot is the only state copy"),
    CrashSpec("after_detach_snapshot", ("detach",), "none",
              "disk snapshot written, guest still bound"),
    CrashSpec("after_unbind", ("detach",), "complete",
              "guest unbound, attach record still on disk"),
    CrashSpec("before_unpause_restore", ("unpause",), "none",
              "devices re-allocated, nothing restored"),
    CrashSpec("after_unpause_restore", ("unpause",), "complete",
              "VF re-attached, guest not yet resumed"),
    CrashSpec("qmp_timeout", ("qmp",), "none",
              "command applied, monitor died before the response"),
    # -- request-granular live migration. outcome names the
    # MIGRATION's fate: "none" == the request stays on the source (roll
    # back), "complete" == it resumes on the target (roll forward). The
    # source tenant's status is "running" either way (that is what
    # COMPLETED_STATUS["migrate_request"] encodes for I8).
    CrashSpec("migrate_mid_extract", ("migrate_request",), "none",
              "chain gathered host-side, source slot frozen; nothing "
              "destructive has run"),
    CrashSpec("migrate_mid_ship", ("migrate_request",), "none",
              "KV block descriptors mid-pipeline; target untouched"),
    CrashSpec("migrate_after_target_admit", ("migrate_request",),
              "complete",
              "target admitted the request (owns pages + slot); source "
              "still frozen — recovery releases the source copy"),
    CrashSpec("migrate_before_source_free", ("migrate_request",),
              "complete",
              "last instant before the only destructive step; same "
              "target-owns predicate rolls forward"),
    # -- elastic pipeline gangs. outcome names the GANG OP's
    # fate. attach_group "none" is the one rollback whose victim does
    # NOT return to its pre-op status: the lead was attached (and its
    # state recorded) before the window, so rolling the gang back
    # detaches it — the lead ends "detached" with state parked on disk,
    # re-attachable as a whole gang. reshape outcomes are asserted on
    # ``stage_width`` (+ I14), since the lead stays "running" either way
    # (COMPLETED_STATUS["reshape"]).
    CrashSpec("gang_mid_member", ("attach_group",), "none",
              "lead attached and journaled, first shell mid-attach; "
              "recovery detaches the running members and parks the "
              "gang (lead ends detached, not created)"),
    CrashSpec("gang_before_commit", ("attach_group",), "complete",
              "every member running, gang WAL commit lost; recovery "
              "rolls the whole gang forward"),
    CrashSpec("reshape_mid_members", ("reshape",), "none",
              "reshape journaled, no member touched yet; recovery "
              "restores the old width exactly (grow and shrink alike)"),
    CrashSpec("reshape_before_commit", ("reshape",), "complete",
              "members attached/detached to the new width, commit "
              "lost; recovery re-applies the new template"),
)}


def state_fingerprint(mgr: SVFFManager) -> str:
    """Deterministic digest of everything recovery reconstructs: pool,
    tenants, snapshot table, records, journal entry resolutions. Two
    managers with equal fingerprints are management-plane-identical."""
    q = mgr.query()
    blob = json.dumps(
        [q["pool"], q["tenants"],
         sorted((k, v) for k, v in q["paused_snapshots"].items()),
         mgr.records.list(),
         [(e["seq"], e["op"], e["tenant"], e["status"])
          for e in mgr.journal.entries()]],
        sort_keys=True, default=str)
    return f"{zlib.crc32(blob.encode()):08x}"


def recover_manager(mgr: SVFFManager, tenants: dict, *,
                    policy: Optional[str] = None,
                    workdir: Optional[str] = None,
                    num_queues: int = 2,
                    check_idempotent: bool = True) -> SVFFManager:
    """Standard post-crash sequence: ``SVFFManager.recover`` from the dead
    manager's survivable pieces, then (I9) assert a second recovery is a
    bit-identical no-op."""
    kw = dict(tenants=tenants, workdir=workdir or mgr.workdir,
              scheduler=policy, pause_enabled=mgr.pause_enabled)
    new = SVFFManager.recover(mgr.journal, mgr.pool, mgr.records,
                              StagingEngine(num_queues=num_queues),
                              snapshots=mgr.snapshots, **kw)
    if check_idempotent:
        fp1 = state_fingerprint(new)
        again = SVFFManager.recover(new.journal, new.pool, new.records,
                                    StagingEngine(num_queues=num_queues),
                                    snapshots=new.snapshots, **kw)
        fp2 = state_fingerprint(again)
        if fp1 != fp2:
            raise InvariantViolation(
                f"I9 recovery not idempotent: {fp1} != {fp2}")
        new = again
    return new


#: the crash points the port recovers: all 19 of the catalogue
PORTED_POINTS = tuple(sorted(CRASH_POINTS))


def _fire(mgr: SVFFManager, trigger: str, point: str,
          victim: Optional[SimTenant]) -> int:
    """Arm ``point``, run ``trigger``, and require the injected crash.
    Returns how many live-pause background steps the victim took before
    the crash (they count toward its expected step total)."""
    stepped = [0]
    crash_plane.arm(point)
    try:
        if trigger == "attach":
            mgr.attach(victim)
        elif trigger == "pause":
            mgr.pause(victim)
        elif trigger == "pause_live":
            def _live_step():
                victim.run_steps(1)
                stepped[0] += 1
            mgr.pause_live(victim, rounds=2, step_fn=_live_step)
        elif trigger == "detach":
            mgr.detach(victim)
        elif trigger == "unpause":
            mgr.unpause(victim)
        elif trigger == "qmp":
            ControlPlane(mgr).execute({"execute": "query-status"})
        elif trigger == "migrate_request":
            dst = next(tn for tid, tn in sorted(mgr.tenants.items())
                       if tn is not victim
                       and getattr(tn, "status", None) == "running"
                       and hasattr(tn, "admit_migrated"))
            mgr.migrate_request(victim, dst)
        elif trigger == "attach_group":
            mgr.attach_group(victim)
        elif trigger == "reshape":
            # the target width is staged on the lead by run_crash_case
            mgr.reshape(victim, victim._crash_reshape_k)
        else:
            raise ValueError(f"unknown crash trigger {trigger!r}")
        raise InvariantViolation(
            f"crash point {point!r} never fired during {trigger!r}")
    except InjectedCrash:
        pass
    finally:
        crash_plane.disarm()
    return stepped[0]


def run_crash_case(point: str, seed: int, policy: str = "first_fit",
                   workdir: Optional[str] = None, device="cuda") -> dict:
    """One crash-matrix cell. Raises ``InvariantViolation`` (tagged with
    point/seed/policy) on any recovery failure; returns a result row."""
    spec = CRASH_POINTS[point]
    trigger = spec.triggers[seed % len(spec.triggers)]
    dev = resolve_device(device)
    wd = workdir or tempfile.mkdtemp(prefix="svff_chaos_")
    clock = VirtualClock()
    try:
        pool = DevicePool(devices=tuple(f"chaosdev{i}" for i in range(8)),
                          max_vfs=4)
        mgr = SVFFManager(pool, workdir=wd,
                          staging=StagingEngine(num_queues=2),
                          scheduler=policy)
        tenants: dict[str, SimTenant] = {}

        def make(tid: str, s: int) -> SimTenant:
            tenants[tid] = SimTenant(tid, seed=s, clock=clock,
                                     placement=policy, device=dev)
            return tenants[tid]

        bystander = make("vm0", seed * 13 + 1)
        mig_rid = target = None
        if trigger == "migrate_request":
            # serve-shaped cell: sv0 decodes a request mid-flight, sv1 is
            # the (idle, capacious) migration target
            victim = SimServeTenant("sv0", seed=seed * 13 + 2, clock=clock,
                                    placement=policy, device=dev)
            target = SimServeTenant("sv1", seed=seed * 13 + 3, clock=clock,
                                    placement=policy, device=dev)
            tenants[victim.tid], tenants[target.tid] = victim, target
            mgr.init(num_vfs=4, tenants=[bystander, victim, target],
                     devices_per_vf=2)
            bystander.run_steps(1 + seed % 3)
            victim.submit_burst(3)
            for _ in range(6):               # drive to a decoding slot
                victim.run_steps(1)
                if victim.peek_migratable() is not None:
                    break
            mig_rid = victim.peek_migratable()
            if mig_rid is None:
                raise InvariantViolation(
                    "setup: sv0 never reached an in-flight request")
        elif trigger in ("attach_group", "reshape"):
            # gang-shaped cell: pg0 is a pipeline lead with shells up to
            # width 3, vm0 the bystander. 8 devices / 4 VFs at 2 devices
            # each: bystander + lead + one shell = 3 VFs, leaving one
            # free so the grow direction of reshape is placeable.
            victim = SimPipelineTenant("pg0", seed=seed * 13 + 2,
                                       clock=clock, placement=policy,
                                       width=2, max_width=3, device=dev)
            tenants[victim.tid] = victim
            for sh in victim.gang_shells:
                tenants[sh.tid] = sh
            mgr.init(num_vfs=4, tenants=[bystander], devices_per_vf=2)
            bystander.run_steps(1 + seed % 3)
            if trigger == "reshape":
                # the gang must already be live, with traffic in flight
                # so I10 is checked ACROSS the crashed width change
                mgr.attach_group(victim)
                victim.submit_burst(2)
                victim.run_steps(2)
                victim._crash_reshape_k = 1 if seed % 2 else 3
        else:
            other = make("vm1", seed * 13 + 2)
            mgr.init(num_vfs=3, tenants=[bystander, other],
                     devices_per_vf=2)
            bystander.run_steps(1 + seed % 3)
            other.run_steps(1 + (seed // 3) % 3)
            if trigger == "unpause":
                mgr.pause(other)
                victim = other
            elif trigger == "attach":
                victim = make("vm2", seed * 13 + 3)
            else:
                victim = other
        check_invariants(mgr)
        pre_status = victim.status
        pre_steps = {tid: tn.steps_done for tid, tn in tenants.items()}

        stepped = _fire(mgr, trigger, point, victim)

        # the manager process is gone; rebuild from the survivors
        mgr = recover_manager(mgr, tenants, policy=policy, workdir=wd)
        check_invariants(mgr)                       # I1-I8 (incl. I4 bits)

        # the cataloged outcome: rolled back == never issued,
        # rolled forward == fully applied
        want = (pre_status if spec.outcome == "none"
                else _COMPLETED_STATUS[trigger])
        if trigger == "qmp":
            want = pre_status
        if trigger == "attach_group" and spec.outcome == "none":
            # the one rollback that does not restore the pre-op status:
            # the lead was attached before the window, so rolling the
            # gang back detaches it (state parked on disk, catalogued)
            want = "detached"
        if victim.status != want:
            raise InvariantViolation(
                f"outcome: {trigger} + {point} left {victim.tid} "
                f"{victim.status!r}, catalogue says {want!r}")
        for tid, steps in pre_steps.items():
            add = stepped if tid == victim.tid else 0
            if tenants[tid].steps_done != steps + add:
                raise InvariantViolation(
                    f"step counter drift for {tid} across crash+recover: "
                    f"{tenants[tid].steps_done} != {steps + add}")

        if trigger in ("attach_group", "reshape"):
            # I14 sharpened per-cell: the recovered gang is at exactly
            # the cataloged width with exactly width-1 running shells —
            # a half-attached gang or half-applied reshape fails here
            # even before check_invariants would catch it
            live = [sh.tid for sh in victim.gang_shells
                    if sh.status == "running"]
            if trigger == "attach_group" and spec.outcome == "none":
                if live:
                    raise InvariantViolation(
                        f"gang rollback after {point} left shells "
                        f"running: {live}")
            else:
                want_k = (victim._crash_reshape_k
                          if trigger == "reshape"
                          and spec.outcome == "complete" else 2)
                if victim.stage_width != want_k:
                    raise InvariantViolation(
                        f"gang outcome: width {victim.stage_width} != "
                        f"cataloged {want_k} after {point} recovery")
                if len(live) != want_k - 1:
                    raise InvariantViolation(
                        f"gang outcome: {len(live)} running shells "
                        f"{live} after {point} recovery, want "
                        f"{want_k - 1}")

        if trigger == "migrate_request":
            # I13 sharpened per-cell: the request survives on exactly the
            # cataloged side, no slot stays frozen, and driving both
            # engines to completion yields the no-migration oracle token
            # stream (extended I10 — zero in-flight work lost)
            owner, loser = ((target, victim) if spec.outcome == "complete"
                            else (victim, target))
            if not owner.owns_request(mig_rid):
                raise InvariantViolation(
                    f"migration outcome: {owner.tid} should own request "
                    f"{mig_rid} after {point} recovery, but does not")
            if loser.owns_request(mig_rid):
                raise InvariantViolation(
                    f"migration outcome: request {mig_rid} live on BOTH "
                    f"engines after {point} recovery")
            if victim._migrating:
                raise InvariantViolation(
                    f"frozen slot survived recovery: {victim._migrating}")
            req = next(r for r in victim.requests if r.rid == mig_rid)
            for _ in range(40):
                victim.run_steps(1)
                target.run_steps(1)
                if req.done:
                    break
            if not req.done:
                raise InvariantViolation(
                    f"request {mig_rid} stranded after {point} recovery")
            oracle = SimServeTenant.expected_output(req.seed, req.rid)
            if req.out != oracle:
                raise InvariantViolation(
                    f"I10 after migration crash: request {mig_rid} "
                    f"emitted {req.out}, oracle {oracle}")
            check_invariants(mgr)

        # post-recovery liveness: survivors still reconfigure and step
        # with bit-identical state
        if victim.status == "paused":
            mgr.unpause(victim)
        elif victim.status == "detached":
            if getattr(victim, "gang_shells", None):
                mgr.attach_group(victim)    # a parked gang re-attaches whole
            else:
                mgr.attach(victim)
        if victim.status == "running":
            victim.run_steps(1)
        mgr.pause(bystander)
        mgr.unpause(bystander)
        bystander.run_steps(1)
        check_invariants(mgr)
        return {"point": point, "trigger": trigger, "seed": seed,
                "policy": policy, "outcome": spec.outcome, "ok": True}
    except InvariantViolation as e:
        raise InvariantViolation(
            f"crash case point={point} seed={seed} policy={policy} "
            f"trigger={trigger}: {e}") from e
    finally:
        crash_plane.disarm()
        if workdir is None:
            shutil.rmtree(wd, ignore_errors=True)


def crash_matrix(points: Optional[Iterable[str]] = None,
                 seeds: Sequence[int] = tuple(range(20)),
                 policies: Sequence[str] = ("first_fit", "best_fit",
                                            "fair_share"),
                 raise_on_fail: bool = True, device="cuda") -> dict:
    """The crash matrix: points x seeds x policies. The default points are
    ``PORTED_POINTS``, all 19 windows of the catalogue (attach, detach,
    pause, pause_live, unpause, the QMP monitor, request migration and
    the gang ops). Returns the result table."""
    points = list(points) if points is not None else list(PORTED_POINTS)
    cases, failures = [], []
    for point in points:
        for policy in policies:
            for seed in seeds:
                try:
                    cases.append(run_crash_case(point, seed, policy,
                                                device=device))
                except Exception as e:
                    # not only InvariantViolation: a red cell that dies
                    # with e.g. a recovery RuntimeError must still land
                    # in failures[] so the matrix report shows it
                    # instead of aborting the whole sweep
                    if raise_on_fail:
                        raise
                    failures.append({"point": point, "seed": seed,
                                     "policy": policy, "error": repr(e)})
    return {"cases": cases, "failures": failures,
            "summary": {"points": len(points),
                        "seeds": len(list(seeds)),
                        "policies": list(policies),
                        "num_cases": len(cases) + len(failures),
                        "num_failures": len(failures)}}
