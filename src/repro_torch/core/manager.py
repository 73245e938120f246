"""SVFFManager — the framework's automation layer (paper §IV-B3; mirrors
``repro.core.manager``).

Provides the two user-facing operations:

  init(num_vfs, tenants)   first-time setup: rescan, partition ("set #VF"),
                           flash (compile executables), attach tenants.
  reconf(num_vfs, ...)     change the VF partition. With pause enabled
                           (default), live tenants are PAUSED — not removed
                           from their guests — the pool is repartitioned,
                           and tenants are unpaused onto the new layout.
                           With pause disabled, the standard SR-IOV
                           detach/attach cycle runs instead (the paper's
                           baseline column in Tables I/II).

Every reconf returns per-macro-step timings matching Table II rows:
  rescan / remove_vf / change_num_vf / add_vf.

The manager also owns the fault-tolerance paths (migrate a straggler's
tenant via pause->rebind; detach snapshots double as restart checkpoints)
and request-granular live migration (``migrate_request``: one in-flight
request's KV block chain shipped between two serving tenants through
the staging engine, journaled, with its four crash windows recovered)
and the gang ops of pipeline-parallel engines (``attach_group``,
``detach_group``, ``reshape``: one engine spanning K VFs, attached whole
or not at all and re-instantiated at another width live, with the crash
windows ``gang_mid_member``, ``gang_before_commit``,
``reshape_mid_members`` and ``reshape_before_commit`` recovered).
A ``migrate_request`` whose target lives on another host
(``dst_host``, the federation plane of ``core.federation``) resolves its
target in recovery through ``peer_lookup`` and defers while that host is
unreachable.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Optional, Sequence

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.errors import (HostUnreachableError, ManagerError,
                                     UnknownTenantError)
from repro_torch.core.fault import InjectedCrash, crashpoint
from repro_torch.core.journal import OpJournal, PENDING
from repro_torch.core.pause import (PauseError, PhaseTimings,
                                    validate_pausable, pause_vf,
                                    pause_vf_live, unpause_vf)
from repro_torch.core.pool import DevicePool, PoolError
from repro_torch.core.records import RecordStore
from repro_torch.core.scheduler import (PlacementRequest, Scheduler,
                                        make_scheduler)
from repro_torch.core.snapshot import ConfigSpaceSnapshot
from repro_torch.core.staging import StagingEngine
from repro_torch.core.vf import VFState, VirtualFunction

__all__ = ["ManagerError", "SVFFManager", "UnknownTenantError"]


class SVFFManager:
    def __init__(self, pool: DevicePool, *,
                 staging: Optional[StagingEngine] = None,
                 workdir: Optional[str] = None,
                 pause_enabled: bool = True,
                 scheduler: "Scheduler | str | None" = None,
                 records: Optional[RecordStore] = None,
                 journal: Optional[OpJournal] = None,
                 peer_lookup=None):
        #: federation hook — ``peer_lookup(host_id, tid) -> tenant|None``
        #: resolves a tenant living on ANOTHER host (raising
        #: ``HostUnreachableError`` when the fabric is partitioned).
        #: ``None`` keeps the single-host behaviour everywhere.
        self.peer_lookup = peer_lookup
        self.pool = pool
        self.staging = staging or StagingEngine()
        self.pause_enabled = pause_enabled
        # a fresh private directory unless the caller names one
        workdir = workdir or tempfile.mkdtemp(prefix="svff_")
        self.workdir = workdir
        self.records = records or RecordStore(os.path.join(workdir,
                                                           "records"))
        self.journal = journal or OpJournal(os.path.join(workdir,
                                                         "journal"))
        self.detach_store_dir = os.path.join(workdir, "detached")
        self.tenants: dict = {}
        self.snapshots: dict[str, ConfigSpaceSnapshot] = {}   # RAM (paused)
        self._detach_counter = 0
        if isinstance(scheduler, str):
            scheduler = make_scheduler(scheduler)
        # None -> resolve per attach from the tenant's RunConfig.placement
        self.scheduler: Optional[Scheduler] = scheduler

    # ------------------------------------------------------------- WAL helper
    def _resolve_failed(self, seq: int) -> None:
        """Inline self-heal for a CLEAN (non-crash) failure between
        ``journal.begin`` and ``journal.commit`` on a live manager: the
        pending intent is reconciled with exactly the recovery logic a
        restarted manager would apply (roll forward if the destructive
        step ran, back otherwise), so no pending entry ever outlives the
        op and I8 holds without requiring a restart. Never masks the
        original exception."""
        try:
            e = self.journal.read(seq)
            if e["status"] == PENDING:
                self._recover_entry(e, self.snapshots)
        except Exception:
            pass

    # ------------------------------------------------------------------ attach
    def _scheduler_for(self, tenant) -> Scheduler:
        if self.scheduler is not None:
            return self.scheduler
        return make_scheduler(getattr(tenant.run, "placement", "first_fit"))

    def _free_vf(self, tenant) -> VirtualFunction:
        """Placement-policy delegation (was: first detached VF scan)."""
        sched = self._scheduler_for(tenant)
        return sched.select(self.pool, self.tenants,
                            PlacementRequest(tenant_id=tenant.tid))

    def attach(self, tenant, vf_id: Optional[str] = None,
               state=None) -> PhaseTimings:
        """Full attach path: record validation + bind + record write."""
        t = PhaseTimings()
        t0 = time.perf_counter()
        sched = self._scheduler_for(tenant)
        req = PlacementRequest(tenant_id=tenant.tid)
        if vf_id:
            # explicit placement still goes through admission control —
            # e.g. a double attach must not leak the tenant's current VF
            sched.admit(self.pool, self.tenants, req)
            vf = self.pool.find(vf_id)
        else:
            vf = sched.select(self.pool, self.tenants, req)
        if vf.state != VFState.DETACHED:
            # validate BEFORE any mutation: a late VFTransitionError would
            # leave owner/tenant state half-updated
            raise PoolError(
                f"cannot attach {tenant.tid}: {vf.vf_id} is "
                f"{vf.state.value}, not detached")
        try:   # attach re-validates any existing record (QDMA-manager checks)
            self.records.validate(tenant.tid, self.pool)
        except Exception:
            pass
        t.add("validate", time.perf_counter() - t0)

        t0 = time.perf_counter()
        if state is None:
            store = CheckpointStore(self.detach_store_dir)
            step = self._detached_steps(store).get(tenant.tid)
            if step is not None:
                # restore from the disk snapshot the detach wrote (read-
                # only preparation: a corrupt snapshot must fail BEFORE
                # the WAL entry exists, so the failure stays a clean,
                # I8-preserving rejection)
                state = store.restore(step, tenant.state_template(),
                                      tenant.shardings_for(vf))
                meta = store.metadata(step)
                tenant.steps_done = meta.get("steps_done",
                                             tenant.steps_done)
        # WAL: every check passed — log the intent before the first mutation
        entry = self.journal.begin("attach", tenant.tid, vf_id=vf.vf_id)
        try:
            compile_s = tenant.bind(vf, state=state)
            vf.owner = tenant.tid
            vf.transition(VFState.ATTACHED)
            self.tenants[tenant.tid] = tenant
            t.add("bind", time.perf_counter() - t0)
            t.add("compile", compile_s)

            t0 = time.perf_counter()
            self.records.write(tenant.tid, vf.describe(),
                               tenant.run.model.name)
            t.add("record", time.perf_counter() - t0)
            self.journal.commit(entry)
        except InjectedCrash:
            raise                      # a crash leaves the intent pending
        except Exception:
            # clean failure (e.g. compile error): self-heal the intent —
            # rolled back if bind never completed, forward otherwise
            self._resolve_failed(entry)
            raise
        return t

    def _detached_steps(self, store: Optional[CheckpointStore] = None
                        ) -> dict:
        """tenant_id -> checkpoint step for disk-parked detach snapshots."""
        store = store or CheckpointStore(self.detach_store_dir)
        out = {}
        for s in store.steps():
            meta = store.metadata(s)
            out[meta.get("tenant_id", "?")] = s
        return out

    # ------------------------------------------------------------------ detach
    def detach(self, tenant) -> PhaseTimings:
        """Standard SR-IOV detach: snapshot to DISK, unbind, free devices.
        The guest loses the device (tenant.status = detached)."""
        t = PhaseTimings()
        vf = self.pool.find(tenant.vf_id)
        if vf.state != VFState.ATTACHED or vf.owner != tenant.tid:
            # validate BEFORE the disk snapshot / unbind: detaching e.g. a
            # PAUSED VF must fail atomically (paper: unpause first)
            raise PoolError(
                f"cannot detach {tenant.tid}: {vf.vf_id} is "
                f"{vf.state.value} (owner {vf.owner})")
        # WAL: record the intent (and the disk-snapshot step it will use,
        # so a rollback can delete the orphan) before the first write
        entry = self.journal.begin("detach", tenant.tid, vf_id=vf.vf_id,
                                   step=self._detach_counter + 1)
        try:
            t0 = time.perf_counter()
            state = tenant.export_state()
            payload = self.staging.save(state, tenant=tenant.tid)
            self._detach_counter += 1
            store = CheckpointStore(self.detach_store_dir, keep=0)
            store.save(self._detach_counter, payload,
                       metadata={"tenant_id": tenant.tid,
                                 "steps_done": tenant.steps_done})
            t.add("snapshot_disk", time.perf_counter() - t0)
            # crash window: disk snapshot written, guest still bound —
            # recovery rolls BACK (delete the orphan, tenant keeps running)
            crashpoint("after_detach_snapshot")

            t0 = time.perf_counter()
            # the tenant drops its device tensors in detach(); the exported
            # tree held the last other references
            del state
            tenant.detach()
            vf.owner = None
            vf.emulated.clear()
            # NOTE: unlike pause, detach does NOT release devices — the VF
            # still exists on the bus with its resources (SR-IOV
            # semantics); only set_num_vfs / pause change device ownership.
            vf.transition(VFState.DETACHED)
            # crash window: unbind complete but the attach record still on
            # disk — recovery rolls FORWARD (remove the record, commit)
            crashpoint("after_unbind")
            self.records.remove(tenant.tid)
            # the staging memo's device refs are dead after unbind; drop
            # them so the memo stays bounded across tenant churn
            self.staging.clear(tenant.tid)
            t.add("unbind", time.perf_counter() - t0)
            self.journal.commit(entry)
        except InjectedCrash:
            raise                      # a crash leaves the intent pending
        except Exception:
            self._resolve_failed(entry)
            raise
        return t

    # ------------------------------------------------------------------ pause
    def pause(self, tenant) -> PhaseTimings:
        vf = self.pool.find(tenant.vf_id)
        validate_pausable(vf, tenant)           # reject BEFORE the WAL entry
        entry = self.journal.begin("pause", tenant.tid, vf_id=vf.vf_id)
        try:
            # the sink registers the snapshot in host RAM before the
            # destructive suspend, which is what makes mid-pause crashes
            # recoverable (see core/pause.py)
            snap, t = pause_vf(self.pool, vf, tenant, self.staging,
                               sink=self.snapshots)
            self.journal.commit(entry)
        except InjectedCrash:
            raise
        except Exception:
            self._resolve_failed(entry)
            raise
        return t

    def pause_live(self, tenant, *, rounds: int = 2,
                   step_fn=None) -> PhaseTimings:
        """Pre-copy live pause: the tenant keeps stepping through
        ``rounds`` background snapshot rounds (``step_fn`` models its
        concurrent work); only the final stop-and-copy — ``t.stop_ms`` —
        stalls it."""
        vf = self.pool.find(tenant.vf_id)
        validate_pausable(vf, tenant)
        entry = self.journal.begin("pause_live", tenant.tid, vf_id=vf.vf_id)
        try:
            snap, t = pause_vf_live(self.pool, vf, tenant, self.staging,
                                    rounds=rounds, step_fn=step_fn,
                                    sink=self.snapshots)
            self.journal.commit(entry)
        except InjectedCrash:
            raise
        except Exception:
            self._resolve_failed(entry)
            raise
        return t

    def unpause(self, tenant, vf_id: Optional[str] = None,
                num_devices: Optional[int] = None) -> PhaseTimings:
        # the RAM snapshot is the paused tenant's ONLY state copy — drop
        # it only after the unpause fully succeeded, so a failed unpause
        # (bad vf_id, no free devices) stays retryable
        if tenant.tid not in self.snapshots:
            raise UnknownTenantError(
                f"cannot unpause {tenant.tid}: no RAM snapshot "
                f"(status {getattr(tenant, 'status', '?')})")
        snap = self.snapshots[tenant.tid]
        vf = (self.pool.find(vf_id) if vf_id
              else self.pool.find(tenant.vf_id))
        if vf.state != VFState.PAUSED:
            raise PauseError(f"{vf.vf_id} is not paused")
        entry = self.journal.begin("unpause", tenant.tid, vf_id=vf.vf_id)
        try:
            t = unpause_vf(self.pool, vf, tenant, snap, self.staging,
                           num_devices=num_devices)
            vf.owner = tenant.tid
            del self.snapshots[tenant.tid]
            self.journal.commit(entry)
        except InjectedCrash:
            raise
        except Exception:
            # clean rejection/failure (e.g. no free devices): self-heal
            # the intent so the op stays retryable with the snapshot kept
            self._resolve_failed(entry)
            raise
        return t

    # ------------------------------------------------------------------ init
    def init(self, num_vfs: int, tenants: Sequence,
             devices_per_vf: Optional[int] = None) -> PhaseTimings:
        t = PhaseTimings()
        t0 = time.perf_counter()
        self.pool.rescan()
        t.add("rescan", time.perf_counter() - t0)

        t0 = time.perf_counter()
        self.pool.set_num_vfs(num_vfs, devices_per_vf)
        t.add("change_num_vf", time.perf_counter() - t0)

        for tn in tenants:
            # a gang lead (an engine spanning K VFs) attaches its whole
            # gang atomically; everything else takes the single-VF path
            if getattr(tn, "gang_shells", None):
                ta = self.attach_group(tn)
            else:
                ta = self.attach(tn)
            t.add("add_vf", ta.total)
        return t

    # ------------------------------------------------------------------ reconf
    def reconf(self, num_vfs: int, new_tenants: Sequence = (),
               devices_per_vf: Optional[int] = None,
               use_pause: Optional[bool] = None) -> dict:
        """The paper's reconfiguration cycle. Returns Table-II style timings
        (seconds): {rescan, remove_vf, change_num_vf, add_vf, total}."""
        use_pause = self.pause_enabled if use_pause is None else use_pause
        timings = {}

        # 1. rescan — be sure every PF/VF on the bus is discovered
        t0 = time.perf_counter()
        self.pool.rescan()
        timings["rescan"] = time.perf_counter() - t0

        # 2. remove VF — pause (live guests keep their device) or detach
        t0 = time.perf_counter()
        live = [tn for tn in self.tenants.values()
                if tn.status == "running"]
        for tn in live:
            if use_pause:
                self.pause(tn)
            else:
                self.detach(tn)
        timings["remove_vf"] = time.perf_counter() - t0

        # 3. change #VF on the PF
        t0 = time.perf_counter()
        self.pool.set_num_vfs(num_vfs, devices_per_vf)
        timings["change_num_vf"] = time.perf_counter() - t0

        # 4. add VF — unpause previously-paused tenants; attach new ones
        t0 = time.perf_counter()
        for tn in live:
            if use_pause:
                # paused VFs kept their identity; give them devices again
                vf = self.pool.find(tn.vf_id)
                if not vf.devices:
                    self.pool.allocate(
                        vf, devices_per_vf
                        or max(1, self.pool.num_devices // max(num_vfs, 1)))
                self.unpause(tn)
            else:
                self.attach(tn)
        for tn in new_tenants:
            if getattr(tn, "gang_shells", None):
                self.attach_group(tn)
            else:
                self.attach(tn)
        timings["add_vf"] = time.perf_counter() - t0
        timings["total"] = sum(timings.values())
        return timings

    # --------------------------------------------------------- fault tolerance
    def migrate(self, tenant) -> dict:
        """Straggler/failure mitigation: move a tenant to fresh devices via
        pause -> release -> allocate elsewhere -> unpause. The migrate
        itself is journaled, and its pause/unpause halves journal their
        own entries — so a crash mid-migrate recovers the inner op first,
        then resolves the migrate (forward if the tenant came back running,
        rolled back to a clean paused state otherwise)."""
        t0 = time.perf_counter()
        vf = self.pool.find(tenant.vf_id)
        validate_pausable(vf, tenant)
        entry = self.journal.begin("migrate", tenant.tid, vf_id=vf.vf_id)
        try:
            n = vf.num_devices
            old = tuple(vf.devices)
            self.pause(tenant)
            # prefer devices not in the old (possibly sick) slice
            self.pool.allocate(vf, n, avoid=old)
            self.unpause(tenant)
            self.journal.commit(entry)
        except InjectedCrash:
            raise
        except Exception:
            # inner ops self-heal their own entries first; the migrate
            # intent then resolves against wherever the tenant landed
            self._resolve_failed(entry)
            raise
        return {"migrate_s": time.perf_counter() - t0,
                "new_devices": [str(d) for d in vf.devices]}

    def migrate_request(self, src, dst, rid: Optional[int] = None, *,
                        dst_host: Optional[str] = None) -> dict:
        """Request-granular live migration: ship ONE in-flight request's
        KV block chain from ``src`` to ``dst`` through the staging
        engine and resume it there token-identically (I10). The paper's
        pause/migrate story pushed down from VF granularity to request
        granularity.

        Ordering is chosen so every step before the source release is
        non-destructive: peek (pure) -> WAL begin -> extract (freeze +
        copy) -> ship -> admit on target -> release on source -> commit.
        A clean failure anywhere (typically target ``CacheExhausted``)
        rolls back via ``_resolve_failed``: the target admitted nothing,
        the source thaws the frozen slot and keeps serving the request —
        the caller may simply retry. Crash windows are catalogued in
        ``sim/chaos.py`` (mid_extract / mid_ship / after_target_admit /
        before_source_free); ``recover`` rolls forward iff the target
        owns the request (invariant I13: live on exactly one engine,
        source pages freed iff target committed). The shipped state is
        restored onto the target's device; a target on another host
        (``dst_host``) names its device itself, this manager's pool holds
        none of that host's VFs."""
        t0 = time.perf_counter()
        for role, tn in (("source", src), ("target", dst)):
            if getattr(tn, "status", None) != "running":
                raise ManagerError(
                    f"migrate_request: {role} {tn.tid} is "
                    f"{getattr(tn, 'status', None)}, not running")
        if src.tid == dst.tid:
            raise ManagerError(
                f"migrate_request: source and target are both {src.tid}")
        for tn, attr in ((src, "extract_request"), (dst, "admit_migrated")):
            if not hasattr(tn, attr):
                raise ManagerError(
                    f"migrate_request: {tn.tid} lacks the request-"
                    f"migration protocol ({attr})")
        rid = src.peek_migratable(rid)
        if rid is None:
            raise ManagerError(
                f"migrate_request: {src.tid} has no migratable in-flight "
                "request")
        # ``dst_host`` marks a CROSS-HOST migration (federation plane):
        # the destination tenant lives under another host's manager, so
        # recovery resolves the entry through ``peer_lookup`` — and
        # DEFERS it (entry stays pending) when that host is unreachable,
        # because resolving blind risks serving the request twice (I15).
        details = {"dst": dst.tid, "rid": rid}
        if dst_host is not None:
            details["dst_host"] = dst_host
        entry = self.journal.begin("migrate_request", src.tid,
                                   vf_id=src.vf_id, **details)
        mig_key = f"{src.tid}/mig:{rid}"
        try:
            payload = src.extract_request(rid)
            if payload is None:
                raise ManagerError(
                    f"migrate_request: {src.tid} lost request {rid} "
                    "between peek and extract")
            # crash window: chain gathered, slot frozen, nothing
            # destructive yet -> recovery rolls BACK
            crashpoint("migrate_mid_extract")
            shipped = self.staging.save(payload["state"], tenant=mig_key)
            # crash window: descriptor pipeline mid-flight, target
            # untouched -> recovery rolls BACK
            crashpoint("migrate_mid_ship")
            vf = None if dst_host is not None else self.pool.vfs.get(
                dst.vf_id)
            state = self.staging.restore(shipped, dst.shardings_for(vf))
            dst.admit_migrated(payload, state)
            # crash window: target committed, source still frozen ->
            # recovery rolls FORWARD (source releases its copy)
            crashpoint("migrate_after_target_admit")
            # crash window: same predicate, last instant before the only
            # destructive step -> recovery rolls FORWARD
            crashpoint("migrate_before_source_free")
            src.release_request(rid)
            self.staging.clear(mig_key)
            self.journal.commit(entry)
        except InjectedCrash:
            raise                      # a crash leaves the intent pending
        except Exception:
            # clean failure (target exhausted, admission rejected): the
            # recovery predicate sees the target does not own the request
            # and rolls back — frozen slot thaws, source keeps serving
            self._resolve_failed(entry)
            raise
        return {"rid": rid, "src": src.tid, "dst": dst.tid,
                "blocks": payload.get("chain_len", 0),
                "migrate_request_s": time.perf_counter() - t0}

    # ------------------------------------------------------------- gang ops
    def _gang_shells(self, lead) -> tuple:
        shells = tuple(getattr(lead, "gang_shells", ()) or ())
        if not shells:
            raise ManagerError(
                f"{lead.tid} is not a gang lead (no gang_shells)")
        return shells

    def attach_group(self, lead) -> PhaseTimings:
        """All-or-nothing attach of a pipeline gang: the lead (stage 0)
        plus K-1 shell members, one VF each. Admission runs through the
        scheduler's ``admit_gang`` BEFORE the WAL entry, so a capacity
        rejection is a typed ``GangPlacementError`` with zero side
        effects. Each member attach journals its own entry inside the
        gang window; the gang entry's recovery predicate — every member
        running — rolls the gang forward iff it fully formed, and
        otherwise detaches whichever members bound (no leaked VFs, no
        half-bound stages)."""
        shells = self._gang_shells(lead)
        k = int(getattr(lead, "stage_width", 1))
        if not 1 <= k <= len(shells) + 1:
            raise ManagerError(
                f"attach_group: {lead.tid} width K={k} exceeds its "
                f"{len(shells) + 1} gang slots")
        members = [lead] + list(shells[:k - 1])
        sched = self._scheduler_for(lead)
        sched.admit_gang(self.pool, self.tenants,
                         [PlacementRequest(tenant_id=m.tid)
                          for m in members])
        entry = self.journal.begin("attach_group", lead.tid, k=k,
                                   members=[m.tid for m in members])
        t = PhaseTimings()
        try:
            for i, m in enumerate(members):
                tm = self.attach(m)
                t.add("add_vf", tm.total)
                if i == 0:
                    # crash window: lead bound, shells not — recovery
                    # rolls BACK (detach the lead, abort the gang)
                    crashpoint("gang_mid_member")
            # crash window: every member bound, gang entry still pending
            # — recovery rolls FORWARD (commit)
            crashpoint("gang_before_commit")
            self.journal.commit(entry)
        except InjectedCrash:
            raise
        except Exception:
            # clean failure (e.g. a member's bind raised): the recovery
            # predicate sees a partial gang and detaches the bound members
            self._resolve_failed(entry)
            raise
        return t

    def detach_group(self, lead) -> PhaseTimings:
        """Detach the whole gang (shells first, lead last). Recovery is
        forward-only: a detach_group intent always completes — whichever
        members survived the crash still bound are detached on recovery."""
        shells = self._gang_shells(lead)
        if getattr(lead, "status", None) != "running":
            raise ManagerError(
                f"detach_group: {lead.tid} is "
                f"{getattr(lead, 'status', None)}, not running")
        members = [s for s in shells
                   if getattr(s, "status", None) == "running"] + [lead]
        entry = self.journal.begin("detach_group", lead.tid,
                                   members=[m.tid for m in members])
        t = PhaseTimings()
        try:
            for m in members:
                tm = self.detach(m)
                t.add("remove_vf", tm.total)
            self.journal.commit(entry)
        except InjectedCrash:
            raise
        except Exception:
            self._resolve_failed(entry)
            raise
        return t

    def reshape(self, lead, k_new: int, *,
                drop: Optional[str] = None) -> dict:
        """Re-instantiate a live gang at width ``k_new`` by attaching idle
        shells (grow) or detaching active ones (shrink), then selecting
        the precomputed stage template via ``lead.apply_reshape``. The
        lead keeps serving throughout — the KV cache and every request
        byte are untouched, so token streams stay bit-identical (I10).
        ``drop`` names the shell to shed first (the VF-loss fallback
        path). Recovery predicate: the gang holds exactly ``k_new``
        running members -> roll forward (re-select the template, commit);
        otherwise undo the member deltas and abort — either way the gang
        matches exactly one registered template (I14)."""
        t0 = time.perf_counter()
        shells = self._gang_shells(lead)
        if getattr(lead, "status", None) != "running":
            raise ManagerError(
                f"reshape: {lead.tid} is "
                f"{getattr(lead, 'status', None)}, not running")
        k_old = int(getattr(lead, "stage_width", 1))
        if k_new == k_old:
            raise ManagerError(
                f"reshape: {lead.tid} already at K={k_old}")
        if not (hasattr(lead, "has_template") and lead.has_template(k_new)):
            raise ManagerError(
                f"reshape: {lead.tid} has no stage template for "
                f"K={k_new}")
        active = [s for s in shells
                  if getattr(s, "status", None) == "running"]
        added: list = []
        dropped: list = []
        if k_new > k_old:
            if drop is not None:
                raise ManagerError(
                    "reshape: drop= only applies to a shrink")
            need = k_new - k_old
            idle = [s for s in shells
                    if getattr(s, "status", None) != "running"]
            if len(idle) < need:
                raise ManagerError(
                    f"reshape: {lead.tid} K={k_old}->{k_new} needs "
                    f"{need} idle shell(s), has {len(idle)}")
            added = idle[:need]
            sched = self._scheduler_for(lead)
            sched.admit_gang(self.pool, self.tenants,
                             [PlacementRequest(tenant_id=s.tid)
                              for s in added])
        else:
            need = k_old - k_new
            order = list(reversed(active))       # shed highest stage first
            if drop is not None:
                victim = next((s for s in active if s.tid == drop), None)
                if victim is None:
                    raise ManagerError(
                        f"reshape: {drop} is not an active shell of "
                        f"{lead.tid}")
                order = [victim] + [s for s in order if s.tid != drop]
            if len(active) < need:
                raise ManagerError(
                    f"reshape: {lead.tid} K={k_old}->{k_new} sheds "
                    f"{need} shell(s), only {len(active)} active")
            dropped = order[:need]
        entry = self.journal.begin(
            "reshape", lead.tid, vf_id=getattr(lead, "vf_id", None),
            k_old=k_old, k_new=k_new,
            added=[s.tid for s in added],
            dropped=[s.tid for s in dropped])
        try:
            # crash window: intent logged, no member touched — recovery
            # rolls BACK (the gang still holds k_old members), so the
            # outcome is deterministic for grow AND shrink directions
            crashpoint("reshape_mid_members")
            for s in added:
                self.attach(s)
            for s in dropped:
                self.detach(s)
            # crash window: member set already at k_new, template not yet
            # selected — recovery rolls FORWARD (apply_reshape + commit)
            crashpoint("reshape_before_commit")
            lead.apply_reshape(k_new)
            self.journal.commit(entry)
        except InjectedCrash:
            raise
        except Exception:
            # clean failure (e.g. a grow attach rejected): the recovery
            # predicate counts a partial gang and undoes the member deltas
            self._resolve_failed(entry)
            raise
        return {"k_old": k_old, "k_new": k_new,
                "added": [s.tid for s in added],
                "dropped": [s.tid for s in dropped],
                "reshape_s": time.perf_counter() - t0}

    def query(self) -> dict:
        return {"pool": self.pool.query(),
                "tenants": {t.tid: t.query() for t in self.tenants.values()},
                "paused_snapshots": {k: v.describe()
                                     for k, v in self.snapshots.items()},
                "pause_enabled": self.pause_enabled,
                "journal_pending": len(self.journal.pending()),
                "scheduler": (self.scheduler.describe() if self.scheduler
                              else {"policy": "per-tenant"})}

    # ------------------------------------------------------------- recovery
    @classmethod
    def recover(cls, journal: "OpJournal | str", pool: DevicePool,
                records: "RecordStore | str",
                staging: Optional[StagingEngine] = None, *,
                tenants: Optional[dict] = None,
                snapshots: Optional[dict] = None,
                workdir: Optional[str] = None,
                pause_enabled: bool = True,
                scheduler: "Scheduler | str | None" = None,
                peer_lookup=None) -> "SVFFManager":
        """Rebuild a manager after the previous one died mid-operation.

        What survives a manager crash — and is therefore handed in — is
        exactly what lives OUTSIDE the manager process: the journal and
        attach records on disk, the device pool (bus state), the guest
        ``tenants`` themselves, and the host-RAM ``snapshots`` table the
        pause path registers into before suspending. Recovery:

          1. sweeps crash debris (``*.part`` files, torn checkpoint tmp
             dirs) and drops every staging memo (device refs are dead);
          2. reconciles each PENDING journal entry newest-first against
             the surviving state, rolling the op FORWARD when its
             destructive step already happened (suspend done, unbind done,
             restore done) and BACK otherwise, then resolves the entry;
          3. adopts the surviving tenants/snapshots and re-derives
             counters (detach step numbering) from disk.

        Calling ``recover`` again on the result is a no-op (recovery
        idempotence, invariant I9).
        """
        if isinstance(records, str):
            records = RecordStore(records)
        if isinstance(journal, str):
            journal = OpJournal(journal)
        workdir = workdir or os.path.dirname(records.dir.rstrip(os.sep))
        staging = staging or StagingEngine()
        mgr = cls(pool, staging=staging, workdir=workdir,
                  pause_enabled=pause_enabled, scheduler=scheduler,
                  records=records, journal=journal,
                  peer_lookup=peer_lookup)

        # -- 1. sweep crash debris; a fresh process holds no device memos
        staging.clear()
        records.sweep_parts()
        journal.sweep_parts()
        store = CheckpointStore(mgr.detach_store_dir, keep=0)
        store.sweep_tmp()

        # -- 2. adopt survivors (resolution below may mutate them)
        tenants = dict(tenants or {})
        snapshots = dict(snapshots) if snapshots is not None else {}
        mgr.tenants = {
            tid: tn for tid, tn in tenants.items()
            if getattr(tn, "status", None) in ("running", "paused",
                                               "detached")}

        # -- 3. reconcile pending intents, newest first (inner ops of a
        # compound op like migrate resolve before the compound entry)
        for e in reversed(journal.pending()):
            mgr._recover_entry(e, snapshots)

        # -- 4. final state: snapshots table is exactly the paused tenants
        mgr.snapshots = {
            tid: s for tid, s in snapshots.items()
            if getattr(mgr.tenants.get(tid), "status", None) == "paused"}
        mgr._detach_counter = max(store.steps(), default=0)
        return mgr

    def _recover_entry(self, e: dict, snapshots: dict) -> None:
        """Roll one pending journal entry forward or back. The decision is
        read off the surviving state: if the op's destructive step already
        ran (the guest was suspended / unbound / its VF re-attached), the
        op completes; otherwise it never happened."""
        op, tid, vf_id = e["op"], e["tenant"], e.get("vf_id")
        seq = e["seq"]
        tn = self.tenants.get(tid)
        vf = self.pool.vfs.get(vf_id) if vf_id else None
        status = getattr(tn, "status", None)

        if op == "attach":
            bound = (status == "running" and vf is not None
                     and getattr(tn, "vf_id", None) == vf.vf_id)
            if bound:
                # bind completed; the pool update and/or record may be
                # missing — finish them (forward), idempotently
                if vf.owner is None:
                    vf.owner = tid
                if vf.state == VFState.DETACHED:
                    vf.transition(VFState.ATTACHED)
                self.records.write(tid, vf.describe(), tn.run.model.name)
                self.journal.commit(seq, recovered="forward")
            else:
                # bind never ran — nothing to undo beyond a stray record
                self.records.remove(tid)
                self.journal.abort(seq, recovered="rollback")

        elif op == "detach":
            if status == "detached":
                # unbind done: finish by dropping the record + memo
                self.records.remove(tid)
                self.staging.clear(tid)
                self.journal.commit(seq, recovered="forward")
            else:
                # guest still bound: delete the orphan disk snapshot
                # (complete or torn) the failed detach may have written
                store = CheckpointStore(self.detach_store_dir, keep=0)
                step = e["details"].get("step")
                if step is not None:
                    store.remove(step)
                store.sweep_tmp()
                self.staging.clear(tid)
                self.journal.abort(seq, recovered="rollback")

        elif op in ("pause", "pause_live"):
            if status == "paused":
                # suspend ran: the registered snapshot is now the only
                # state copy — roll forward to a fully-paused VF
                if tid not in snapshots:
                    raise RuntimeError(
                        f"recovery: {tid} suspended but no snapshot "
                        "registered (unrecoverable)")
                if vf is not None:
                    if vf.state == VFState.ATTACHED:
                        vf.transition(VFState.PAUSED)
                    if vf.devices:
                        vf.release_devices()
                    vf.emulated["status"] = "paused"
                    vf.emulated["steps_done"] = tn.steps_done
                self.staging.clear(tid)
                self.journal.commit(seq, recovered="forward")
            else:
                # guest untouched: drop the half-taken snapshot + memo
                snapshots.pop(tid, None)
                self.staging.clear(tid)
                self.journal.abort(seq, recovered="rollback")

        elif op == "unpause":
            if status == "running":
                # fully resumed; only the bookkeeping commit was lost
                snapshots.pop(tid, None)
                if vf is not None:
                    vf.owner = tid
                self.journal.commit(seq, recovered="forward")
            elif status == "paused" and vf is not None:
                if vf.state == VFState.PAUSED:
                    # restore never ran — roll back: devices (if any were
                    # re-allocated) return to the pool, snapshot retained
                    if vf.devices:
                        vf.release_devices()
                    self.journal.abort(seq, recovered="rollback")
                else:
                    # VF re-attached but guest not resumed — roll forward:
                    # redo the restore from the retained snapshot
                    snap = snapshots.get(tid)
                    if snap is None:
                        raise RuntimeError(
                            f"recovery: {tid} mid-unpause but no snapshot "
                            "registered (unrecoverable)")
                    state = self.staging.restore(snap.payload,
                                                 tn.shardings_for(vf))
                    tn.steps_done = snap.steps_done
                    tn.resume(state, vf)
                    vf.owner = tid
                    vf.emulated["status"] = "running"
                    snapshots.pop(tid, None)
                    self.journal.commit(seq, recovered="forward")
            else:
                self.journal.abort(seq, recovered="rollback")

        elif op == "migrate":
            # inner pause/unpause entries were reconciled first (newest-
            # first order), so the tenant is already in a clean state:
            # running -> the migrate completed; paused -> it stalled after
            # the pause half, which is a clean (resumable) rollback point
            if status == "running":
                self.journal.commit(seq, recovered="forward")
            else:
                self.journal.abort(seq, recovered="rollback")

        elif op == "migrate_request":
            # request-granular migration. Predicate: the TARGET owns the
            # request => the admit committed, roll FORWARD (source frees
            # its copy); otherwise roll BACK (target drops any partial
            # admission, source thaws the frozen slot and keeps serving).
            # Every callee is idempotent, so double recovery (I9) holds.
            # Cross-host entries (details carry ``dst_host``) resolve the
            # target through ``peer_lookup``; when the destination host
            # is unreachable the entry is DEFERRED — left pending with
            # the frozen source slot intact — because the target may have
            # admitted, and rolling back blind would serve the request on
            # two hosts (I15). The next ``recover`` after the partition
            # heals resolves it exactly once (I16).
            rid = e["details"].get("rid")
            dst_host = e["details"].get("dst_host")
            dtn = self.tenants.get(e["details"].get("dst"))
            if dtn is None and dst_host and self.peer_lookup is not None:
                try:
                    dtn = self.peer_lookup(dst_host, e["details"]["dst"])
                except HostUnreachableError:
                    self.journal.defer(seq, deferred_cross_host=True)
                    return
            self.staging.clear(f"{tid}/mig:{rid}")
            dst_owns = (dtn is not None and hasattr(dtn, "owns_request")
                        and dtn.owns_request(rid))
            if dst_owns:
                if tn is not None and hasattr(tn, "release_request"):
                    tn.release_request(rid)
                self.journal.commit(seq, recovered="forward")
            else:
                if dtn is not None and hasattr(dtn, "abort_incoming"):
                    dtn.abort_incoming(rid)
                if tn is not None and hasattr(tn, "abort_migration"):
                    tn.abort_migration(rid)
                self.journal.abort(seq, recovered="rollback")

        elif op == "attach_group":
            # member attach entries are NEWER than the gang entry, so by
            # newest-first order each member is already cleanly running or
            # cleanly unbound. Predicate: the gang fully formed -> forward.
            members = [self.tenants.get(m)
                       for m in e["details"].get("members", [])]
            if members and all(getattr(m, "status", None) == "running"
                               for m in members):
                self.journal.commit(seq, recovered="forward")
            else:
                # partial gang: detach whichever members bound — no leaked
                # VFs, no half-bound stages (the lead ends detached, its
                # state parked on disk like any failed single attach)
                for m in members:
                    if getattr(m, "status", None) == "running":
                        self.detach(m)
                self.journal.abort(seq, recovered="rollback")

        elif op == "detach_group":
            # forward-only: a detach_group intent always completes
            for mid in e["details"].get("members", []):
                mt = self.tenants.get(mid)
                if getattr(mt, "status", None) == "running":
                    self.detach(mt)
            self.journal.commit(seq, recovered="forward")

        elif op == "reshape":
            # predicate: the gang holds exactly k_new running members ->
            # the member deltas completed, roll forward by (re-)selecting
            # the k_new template (idempotent); otherwise undo the deltas
            # back to k_old. Either way the live gang matches exactly one
            # registered template (I14).
            det = e["details"]
            k_old, k_new = det.get("k_old"), det.get("k_new")
            shells = tuple(getattr(tn, "gang_shells", ()) or ())
            alive = int(status == "running") + sum(
                1 for s in shells
                if getattr(s, "status", None) == "running")
            if tn is not None and status == "running" and alive == k_new:
                tn.apply_reshape(k_new)
                self.journal.commit(seq, recovered="forward")
            else:
                for mid in det.get("added", []):
                    mt = self.tenants.get(mid)
                    if getattr(mt, "status", None) == "running":
                        self.detach(mt)
                for s in shells:
                    if (s.tid in det.get("dropped", [])
                            and getattr(s, "status", None) != "running"):
                        self.attach(s)
                if tn is not None and hasattr(tn, "apply_reshape"):
                    tn.apply_reshape(k_old)       # no-op: width never moved
                self.journal.abort(seq, recovered="rollback")

        else:                                     # unknown op: never applied
            self.journal.abort(seq, recovered="rollback")
