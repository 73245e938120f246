"""ServeFleet — N serving engines as tenants under the SVFF manager
(mirrors ``repro.serve.fleet``).

The paper's transparency claim only matters under load: a pause/migrate is
interesting when the paused guest is mid-decode with a full batch and
traffic keeps arriving. The fleet packages exactly that:

  EngineTenant   adapts a ``ServeEngine`` to the manager/pause duck-typed
                 tenant protocol (bind/suspend/resume/export_state/...), so
                 the real pool / scheduler / journal / staging / records
                 paths manage serving guests unchanged
  ServeFleet     owns a DevicePool + SVFFManager, places each engine tenant
                 through the configured placement policy, spreads arriving
                 requests across engines with SLO-aware admission (bounded
                 per-engine load; overloads raise ``RequestRejected``
                 instead of building unbounded queues), and keeps serving
                 THROUGH ``pause_live``/``migrate`` — the pre-copy rounds
                 step the victim engine itself, so reconfiguration fires
                 mid-traffic.

On top of the on-request reconfiguration surface sits the elastic SLO
control plane: a ``MetricsBus`` (``serve/telemetry.py``) samples per-
engine load and latency windows on the hot path, and ``autoscale_step``
feeds one snapshot per epoch to the ``core.autoscaler`` policy loop,
executing its actions through the SAME journaled manager ops —

  scale_out   attach a parked/fresh ``EngineTenant`` to a free VF, or run
              the paper's full reconf cycle to carve one more VF
  scale_in    detach an engine (state parks on disk; its VF keeps its
              devices and becomes the next scale_out's cheap path); a
              busy engine drains first, its in-flight requests live-
              migrating to siblings (``migrate_request``)
  rebalance   move queued requests hot -> cold (they have emitted
              nothing, so moving them is token-identical), live-migrate
              in-flight ones, and migrate the hot victim onto fresh
              devices without dropping its batch

— so crash recovery covers autoscaler-initiated reconfiguration too.
``recover_engine`` re-homes a crashed engine's live requests onto its
siblings by deterministic recompute.

One card is one torch device: every engine of the fleet computes on the
fleet's ``device``, and the pool's slots (``fleetdev0``, ...) are logical,
as in the JAX fleet. A paused or detached engine holds no device memory:
``EngineTenant.suspend`` and ``detach`` drop the engine's params, their
compute copy and its page pools, and ``resume`` (or an attach from disk)
rebuilds them from the snapshot. A parked spare engine (``spare_engines``)
holds its params on the card, ready to attach.

With ``stages > 1`` every engine is a ``PipelineServeEngine`` spanning
``stages`` VFs: a gang of the lead tenant (stage 0, the engine) and
``StageShellTenant`` members, one VF each, with shells up to the stage
template ceiling (``max_stages``). ``reshape_engine`` changes a gang's
width live through the journaled manager reshape, and ``handle_vf_loss``
sheds a dead member's stage the same way. On one card every stage of a
gang computes on the fleet's ``device``: a gang's VFs are logical slots,
and the stages run one after another.

``federation_snapshot`` is the fleet's view as ONE host of a federation
(``core.federation``), built from the bus replica.
"""
from __future__ import annotations

import collections
import tempfile
import types
from typing import Optional

import numpy as np
import torch

from repro_torch.core.autoscaler import (Autoscaler, AutoscaleAction,
                                         AutoscaleConfig, EngineStats,
                                         TelemetrySnapshot)
from repro_torch.core.errors import ManagerError
from repro_torch.core.manager import SVFFManager
from repro_torch.core.pool import DevicePool
from repro_torch.core.tenant import DevicePausedError
from repro_torch.core.vf import VFState, VirtualFunction
from repro_torch.device import resolve_device
from repro_torch.serve.engine import DrainResult, Request, ServeEngine
from repro_torch.serve.paged import CacheExhausted, RequestRejected
from repro_torch.serve.pipeline_engine import PipelineServeEngine
from repro_torch.serve.telemetry import MetricsBus
from repro_torch.tree import tree_map, tree_to


def _template(x):
    """A leaf's shape and dtype without its bytes (restore structure)."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return np.zeros(np.shape(x), dtype=np.asarray(x).dtype)


class EngineTenant:
    """Tenant-protocol adapter around a ServeEngine (the guest's 'VM')."""

    def __init__(self, tid: str, engine: ServeEngine, *,
                 placement: str = "first_fit"):
        self.tid = tid
        self.engine = engine
        self.status = "created"        # created|running|paused|detached
        self.vf_id: Optional[str] = None
        self.steps_done = 0
        self.workload = "serve"
        self._exec_cache: dict = {}
        self._template = None
        # pipeline gang: a stage-spanning engine's K-1 shell members
        # (one VF each, stage 0 rides the lead's own VF). Empty for
        # single-VF engines — the manager dispatches on truthiness.
        self.gang_shells: tuple = ()
        self.run = types.SimpleNamespace(
            model=types.SimpleNamespace(name=engine.run.model.name),
            placement=placement, seed=engine.run.seed)

    # -- lifecycle -----------------------------------------------------------
    def bind(self, vf: VirtualFunction, state=None, *,
             flash: bool = True) -> float:
        if state is not None:
            self.engine.import_state(state)
        key = (tuple(vf.mesh_shape), tuple(str(d) for d in vf.devices))
        self._exec_cache.setdefault(key, True)
        self.vf_id = vf.vf_id
        self.status = "running"
        self.engine.unpause()
        vf.emulated.update({"tenant": self.tid, "status": "running",
                            "steps_done": self.steps_done})
        return 0.0

    def run_steps(self, n: int = 1) -> dict:
        if self.status == "paused":
            raise DevicePausedError(
                f"{self.tid}: device {self.vf_id} is paused")
        if self.status != "running":
            raise RuntimeError(f"{self.tid}: no device attached")
        active = 0
        for _ in range(n):
            active = self.engine.step()
            self.steps_done += 1
        return {"active": active, "queued": len(self.engine.queue)}

    # -- pause protocol ------------------------------------------------------
    def export_state(self):
        # a never-stepped engine must still export a structurally complete
        # state: the detach path round-trips it through CheckpointStore
        # against state_template(), which includes the cache leaves
        self.engine._ensure_cache()
        st = self.engine.export_state()
        if self._template is None:
            self._template = tree_map(_template, st)
        return st

    def export_specs(self):
        return {}

    def shardings_for(self, vf: VirtualFunction):
        """Where a restore places this tenant's state: its engine's
        device (one card holds every slot of the pool)."""
        return self.engine.device

    def state_template(self):
        if self._template is None:
            self.export_state()
        return self._template

    def dirty_keys(self):
        return self.engine.dirty_keys()

    def _drop_device_state(self):
        """Let go of every device tensor the engine holds — params, their
        compute-dtype copy and the page pools — so that, with the exported
        tree and the staging memo dropped by the pause/detach path, the
        card's memory is free ("exit from the IOMMU group")."""
        self.engine.pause()
        self.engine.drop_device_state()

    def suspend(self):
        # in-flight chunked prefills re-queue (they have emitted nothing
        # and are deterministic), so the exported snapshot really is the
        # engine's complete device state
        self.engine.abort_prefill_jobs()
        self._drop_device_state()
        self.status = "paused"

    def resume(self, state, vf: VirtualFunction):
        self.status = "running"
        self.bind(vf, state=state)

    def detach(self):
        self.engine.abort_prefill_jobs()
        self._drop_device_state()
        self.vf_id = None
        self.status = "detached"

    # -- request live migration (delegated to the engine) --------------------
    # the manager's migrate_request op speaks this protocol on the
    # TENANT, so the adapter forwards it 1:1 — EngineTenant and
    # SimServeTenant stay interchangeable under SVFFManager
    def peek_migratable(self, rid: Optional[int] = None):
        return self.engine.peek_migratable(rid)

    def extract_request(self, rid: Optional[int] = None) -> dict:
        return self.engine.extract_request(rid)

    def admit_migrated(self, payload: dict, state) -> int:
        return self.engine.admit_migrated(payload, state)

    def release_request(self, rid: int) -> None:
        self.engine.release_request(rid)

    def abort_migration(self, rid: int) -> None:
        self.engine.abort_migration(rid)

    def abort_incoming(self, rid: int) -> None:
        self.engine.abort_incoming(rid)

    def owns_request(self, rid: int) -> bool:
        return self.engine.owns_request(rid)

    def reset_after_crash(self) -> None:
        self.engine.reset_after_crash()

    # -- pipeline gang protocol (manager gang ops + I14) ---------------------
    @property
    def stage_width(self) -> int:
        return getattr(self.engine, "stage_width", 1)

    @property
    def num_periods(self) -> int:
        return self.engine.num_periods

    def has_template(self, k: int) -> bool:
        return self.engine.has_template(k)

    def apply_reshape(self, k: int) -> None:
        self.engine.apply_reshape(k)

    def stage_bounds(self) -> tuple:
        return self.engine.stage_bounds()

    # -- introspection -------------------------------------------------------
    @property
    def load(self) -> int:
        """Requests this engine is responsible for right now."""
        eng = self.engine
        return (len(eng.queue) + len(eng._jobs)
                + sum(r is not None for r in eng.active))

    def query(self) -> dict:
        return {"tenant": self.tid, "status": self.status,
                "vf": self.vf_id, "steps_done": self.steps_done,
                "workload": self.workload, "load": self.load,
                "exec_keys": [list(map(str, k)) for k in self._exec_cache]}

    def inject_failure(self):
        """The sim's ``fault`` op calls this on any tenant; an engine
        tenant has no fault model, as in the reference."""


class StageShellTenant:
    """One pipeline stage's VF occupant. The LEAD's engine owns ALL
    compute and state (params, KV pages, requests) — the shell exists so
    invariant I1 (one tenant per attached VF) and every journaled manager
    op see the gang's K VFs as K first-class tenants: a shell attaches,
    detaches, pauses and recovers exactly like any tenant, it just has
    (almost) no state of its own."""

    def __init__(self, tid: str, lead: EngineTenant, stage_index: int, *,
                 placement: str = "first_fit"):
        self.tid = tid
        self.lead = lead
        self.stage_index = stage_index
        self.status = "created"        # created|running|paused|detached
        self.vf_id: Optional[str] = None
        self.steps_done = 0
        self.workload = "serve"
        self._exec_cache: dict = {}    # pause snapshots its keys
        self.run = types.SimpleNamespace(
            model=lead.run.model, placement=placement, seed=lead.run.seed)

    # -- lifecycle (the duck-typed tenant protocol, trivially) ---------------
    def bind(self, vf: VirtualFunction, state=None, *,
             flash: bool = True) -> float:
        self.vf_id = vf.vf_id
        self.status = "running"
        vf.emulated.update({"tenant": self.tid, "status": "running",
                            "steps_done": self.steps_done})
        return 0.0

    def export_state(self):
        return {"stage": np.asarray(self.stage_index, np.int32)}

    def state_template(self):
        return {"stage": np.zeros((), np.int32)}

    def export_specs(self):
        return {}

    def shardings_for(self, vf: VirtualFunction):
        """Where a restore places the shell's (host) state: the lead
        engine's device."""
        return self.lead.shardings_for(vf)

    def dirty_keys(self):
        return set()

    def suspend(self):
        self.status = "paused"

    def resume(self, state, vf: VirtualFunction):
        self.bind(vf, state=state)

    def detach(self):
        self.vf_id = None
        self.status = "detached"

    def query(self) -> dict:
        return {"tenant": self.tid, "status": self.status,
                "vf": self.vf_id, "lead": self.lead.tid,
                "stage_index": self.stage_index,
                "workload": self.workload}

    def inject_failure(self):
        pass


class ServeFleet:
    """Run ``num_engines`` ServeEngines as SVFF tenants over one pool."""

    def __init__(self, run, params, *, num_engines: int = 2,
                 num_devices: int = 8, policy: str = "first_fit",
                 slots: int = 4, max_len: int = 256, paged: bool = True,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: int = 0, share_prefix: bool = False,
                 kv_dtype: Optional[str] = None,
                 fused_sampling: bool = False,
                 slo_max_load: int = 64, workdir: Optional[str] = None,
                 devices=None, device="cuda",
                 autoscale: Optional[AutoscaleConfig] = None,
                 spare_engines: int = 0, num_vfs: Optional[int] = None,
                 stages: int = 1, max_stages: Optional[int] = None,
                 microbatches: int = 2, host_id: str = "host0"):
        self.run = run
        self.device = resolve_device(device)
        #: this fleet's identity when it is one member of a federation
        #: (``core.federation``); a standalone fleet keeps the default
        self.host_id = host_id
        self.slo_max_load = slo_max_load
        # stages > 1: every engine is a PipelineServeEngine spanning
        # ``stages`` VFs (a gang of 1 lead + stages-1 shell tenants);
        # ``max_stages`` bounds the reshape headroom (templates are
        # precomputed up to it at engine construction)
        self.stages = max(1, int(stages))
        self.max_stages = max_stages
        self.microbatches = microbatches
        devices = (tuple(devices) if devices is not None else
                   tuple(f"fleetdev{i}" for i in range(num_devices)))
        # the VF cap is the DEVICE budget (>= 1 device per VF), not the
        # initial engine count, so later reconfigurations can grow it
        self.pool = DevicePool(devices=devices,
                               max_vfs=max(len(devices), 1))
        self.mgr = SVFFManager(
            self.pool, scheduler=policy,
            workdir=workdir or tempfile.mkdtemp(prefix="svff_fleet_"))
        self.tenants: dict[str, EngineTenant] = {}
        self._order: dict[str, int] = {}        # tid -> creation index
        self._policy = policy
        self._params_src = params
        self._engine_kw = dict(slots=slots, max_len=max_len, paged=paged,
                               page_size=page_size, num_pages=num_pages,
                               prefill_chunk=prefill_chunk,
                               share_prefix=share_prefix,
                               kv_dtype=kv_dtype,
                               fused_sampling=fused_sampling)
        # pre-carving MORE VFs than engines (``num_vfs``) gives scale-out
        # a pause-free path: attaching to an existing detached VF never
        # interrupts the running engines, whereas growing the partition
        # runs the paper's full reconf cycle (brief pause of every engine)
        tns = [self._spawn_tenant() for _ in range(num_engines)]
        need = num_engines * self.stages      # every gang wants K VFs
        self.mgr.init(max(num_vfs or need, need), tns)
        # parked standbys: spawned (own params copy on the card) but not
        # attached — the autoscaler's cheap scale-out pool
        for _ in range(spare_engines):
            self._spawn_tenant()
        self.telemetry = MetricsBus()
        self.autoscale_config = autoscale
        self.autoscaler = Autoscaler(autoscale) if autoscale else None
        self._epoch = 0
        self._harvested: dict[str, int] = {}   # tid -> _finished scanned
        #: fleet-side rejection ledger (the REQUEST is never mutated), one
        #: entry per rejected submission, bounded
        self.rejections: collections.deque = collections.deque(maxlen=512)
        self.rejected_total = 0

    def _spawn_tenant(self) -> EngineTenant:
        """Create one engine tenant with its own params copy: a pause
        frees the engine's tensors, so engines must not share them —
        guest isolation, like VMs not sharing guest RAM."""
        i = len(self._order)
        params = tree_to(self._params_src, self.device, copy=True)
        if self.stages > 1:
            eng = PipelineServeEngine(self.run, params, stages=self.stages,
                                      max_stages=self.max_stages,
                                      microbatches=self.microbatches,
                                      device=self.device, **self._engine_kw)
        else:
            eng = ServeEngine(self.run, params, device=self.device,
                              **self._engine_kw)
        tn = EngineTenant(f"serve{i}", eng, placement=self._policy)
        if self.stages > 1:
            # shells up to the TEMPLATE ceiling, not the initial width:
            # a grow-reshape needs idle shells ready to attach
            # "." separator: tids become RecordStore file names, so no "/"
            tn.gang_shells = tuple(
                StageShellTenant(f"{tn.tid}.s{j}", tn, j,
                                 placement=self._policy)
                for j in range(1, eng.max_stage_width))
        self.tenants[tn.tid] = tn
        self._order[tn.tid] = i
        return tn

    # -- traffic --------------------------------------------------------------
    def submit(self, req: Request) -> str:
        """SLO-aware admission: the request goes to the least-loaded
        attached engine; if even that one is past ``slo_max_load``, the
        request is rejected NOW (typed) rather than queued into an SLO
        miss. Rejection is side-effect-free on the request — the caller
        may retry the same object — and is tracked fleet-side. Paused
        engines still accept traffic (their queue holds) but running
        ones are preferred. Load ties break on engine creation index."""
        cands = [tn for tn in self.tenants.values()
                 if tn.status in ("running", "paused")]
        if not cands:
            self.rejected_total += 1
            self.rejections.append({"rid": req.rid, "engine": None,
                                    "reason": "no serving engines"})
            raise RequestRejected(f"request {req.rid}: no serving engines")
        running = [tn for tn in cands if tn.status == "running"]
        pick = min(running or cands,
                   key=lambda tn: (tn.load, self._order[tn.tid]))
        if pick.load >= self.slo_max_load:
            self.telemetry.record_reject(pick.tid)
            self.rejected_total += 1
            self.rejections.append({"rid": req.rid, "engine": pick.tid,
                                    "load": pick.load,
                                    "reason": "slo_max_load"})
            raise RequestRejected(
                f"SLO admission: engine {pick.tid} at load {pick.load} "
                f">= {self.slo_max_load} (request {req.rid})")
        pick.engine.submit(req)
        self.telemetry.record_submit(pick.tid)
        return pick.tid

    def step(self) -> int:
        """One fleet iteration: every RUNNING engine advances one step.
        Paused engines hold their queues (the guest keeps its device)."""
        active = 0
        for tn in self.tenants.values():
            if tn.status != "running":
                continue
            active += tn.run_steps(1)["active"]
            self.telemetry.record_load(tn.tid, tn.load,
                                       len(tn.engine.queue))
            self.telemetry.record_cache_pressure(
                tn.tid, tn.engine.stats["cache_exhausted"],
                tn.engine.stats["defrag_events"])
            self.telemetry.record_migration_stall(
                tn.tid, tn.engine.stats["migration_stall_ticks"])
            if getattr(tn.engine, "stage_width", 1) > 1:
                self.telemetry.record_stage_load(
                    tn.tid, tn.engine.stage_loads(),
                    tn.engine.measured_bubble)
            # harvest only the suffix of _finished not yet scanned (drain
            # clears the list; rescanning it whole would make the hot
            # path O(completed history))
            done = len(tn.engine._finished)
            seen = self._harvested.get(tn.tid, 0)
            if done < seen:
                seen = 0        # drained directly: MetricsBus dedups
            if done > seen:
                self.telemetry.harvest(tn.tid, tn.engine._finished[seen:])
            self._harvested[tn.tid] = done
        return active

    def drain(self, max_steps: int = 10_000) -> DrainResult:
        """Serve until every RUNNING engine is idle; returns the finished
        requests. ``.drained`` is False when work is stranded — on a
        still-paused engine, or because max_steps ran out."""
        done: list[Request] = []
        for _ in range(max_steps):
            if self.step() == 0 and not any(
                    tn.engine.queue or tn.engine._jobs
                    for tn in self.tenants.values()
                    if tn.status == "running"):
                break
        pending = False
        for tn in self.tenants.values():
            res = tn.engine.run_until_idle(max_steps=0)
            self.telemetry.harvest(tn.tid, res)
            self.telemetry.drained(tn.tid)
            self._harvested[tn.tid] = 0        # _finished was emptied
            done.extend(res)
            pending |= not res.drained
        return DrainResult(done, drained=not pending)

    # -- reconfiguration under traffic ----------------------------------------
    def pause_live(self, tid: str, *, rounds: int = 2):
        """Live pause of one engine while it KEEPS SERVING its batch: the
        pre-copy rounds step the victim engine (and the rest of the fleet
        rides along untouched)."""
        tn = self.tenants[tid]
        return self.mgr.pause_live(
            tn, rounds=rounds, step_fn=lambda: tn.run_steps(1))

    def unpause(self, tid: str):
        return self.mgr.unpause(self.tenants[tid])

    def migrate(self, tid: str):
        return self.mgr.migrate(self.tenants[tid])

    def migrate_request(self, src: str, dst: str,
                        rid: Optional[int] = None, *,
                        retries: int = 2) -> Optional[dict]:
        """Live-migrate one in-flight request ``src -> dst`` through the
        journaled manager op. A target-side ``CacheExhausted`` aborts the
        attempt CLEANLY — journal rolled back, the request untouched and
        still decoding on the source — and the target defragments before
        the bounded retry. Returns the manager's result dict (rid /
        blocks shipped / timing), or None when every attempt aborted."""
        s, d = self.tenants[src], self.tenants[dst]
        for attempt in range(1 + retries):
            try:
                res = self.mgr.migrate_request(s, d, rid)
            except CacheExhausted:
                self.telemetry.record_migration(src, dst, completed=False)
                if attempt < retries:
                    d.engine.defragment()     # compact, then retry
                continue
            self.telemetry.record_migration(src, dst, completed=True,
                                            blocks=res["blocks"])
            return res
        return None

    # -- the elastic control plane --------------------------------------------
    def _free_vfs(self) -> list:
        """Attachable VFs: detached, unowned, still holding devices. One
        predicate for BOTH the snapshot the planner reads and the VF
        scale_out picks, so plan and execution criteria cannot drift."""
        return [vf for vf in self.pool.vfs.values()
                if vf.state == VFState.DETACHED and vf.owner is None
                and vf.devices]

    def telemetry_snapshot(self) -> TelemetrySnapshot:
        """One observation epoch: per-engine stats + the capacity facts
        that gate scale-out. Cheap (counters + window percentiles)."""
        self._epoch += 1
        stats = []
        for tid, tn in self.tenants.items():
            eng = tn.engine
            stats.append(EngineStats(
                tid=tid, index=self._order[tid], status=tn.status,
                load=tn.load, queue_depth=len(eng.queue),
                inflight=sum(r is not None for r in eng.active),
                prefill_jobs=len(eng._jobs),
                ttft_p95_ms=self.telemetry.ttft_ms(tid),
                itl_p95_ms=self.telemetry.itl_ms(tid),
                rejected=self.telemetry.rejected[tid],
                cache_exhausted=eng.stats["cache_exhausted"],
                defrag_events=eng.stats["defrag_events"],
                pages_in_use=eng.alloc.pages_in_use if eng.paged else 0,
                pages_free=eng.alloc.num_free if eng.paged else 0,
                migrations_attempted=(
                    self.telemetry.migrations_attempted[tid]),
                migrations_completed=(
                    self.telemetry.migrations_completed[tid]),
                migrations_aborted=self.telemetry.migrations_aborted[tid],
                migration_blocks_shipped=self.telemetry.migration_blocks[tid],
                migration_stall_ticks=eng.stats["migration_stall_ticks"],
                stage_width=getattr(eng, "stage_width", 1),
                stage_width_max=getattr(eng, "max_stage_width", 1),
                stage_loads=(tuple(eng.stage_loads())
                             if hasattr(eng, "stage_loads") else ()),
                bubble_frac=getattr(eng, "measured_bubble", 0.0)))
        return TelemetrySnapshot(
            epoch=self._epoch, slo_max_load=self.slo_max_load,
            engines=tuple(stats), free_vfs=len(self._free_vfs()),
            grow_budget=max(0, self.pool.num_devices - len(self.pool.vfs)),
            rejected_recent=self.telemetry.take_rejected_recent())

    def federation_snapshot(self, now: float = 0.0) -> dict:
        """This fleet as ONE host of a federation: the stamped replicated-
        telemetry payload ``core.federation.FederationCoordinator`` keeps
        per host (same shape as ``core.host.Host.snapshot``), built from
        the serve-plane ``MetricsBus`` replica. ``now`` is the caller-
        injected clock reading — wall time never leaks in."""
        engines = {tid: {"load": tn.load,
                         "slots": len(tn.engine.active)}
                   for tid, tn in sorted(self.tenants.items())
                   if tn.status == "running"}
        return {"host_id": self.host_id, "stamp": float(now),
                "load": sum(e["load"] for e in engines.values()),
                "capacity": self.slo_max_load * len(engines),
                "max_load": self.slo_max_load,
                "free_vfs": len(self._free_vfs()),
                "engines": engines,
                "telemetry": self.telemetry.replicate(now)}

    def autoscale_step(self) -> Optional[AutoscaleAction]:
        """One policy-loop epoch: snapshot -> plan -> execute. Returns the
        executed action (None on a quiet/cooldown epoch). Every executed
        action flows through journaled manager ops, so a crash mid-action
        recovers exactly like a crash mid-reconf (I8/I9)."""
        if self.autoscaler is None:
            raise ValueError(
                "fleet built without autoscale=AutoscaleConfig(...)")
        action = self.autoscaler.observe(self.telemetry_snapshot())
        if action is None:
            return None
        if action.kind == "scale_out":
            self.scale_out()
        elif action.kind == "scale_in":
            self.scale_in(action.victim)
        elif action.kind == "reshape":
            self.reshape_engine(action.victim, action.width)
        else:
            self.rebalance(action.victim, action.target)
        return action

    def scale_out(self) -> str:
        """Bring one more engine into service: re-attach the oldest parked
        tenant (or spawn a fresh one) onto a free VF; when no detached VF
        exists, run the paper's full reconf cycle to carve one more
        (running engines pause briefly — their queues hold — and resume
        on the new partition)."""
        free = self._free_vfs()
        # gang-aware device budget: a K-stage engine consumes K VFs, so
        # "is there room" counts the VFs a whole gang needs, not 1
        missing = max(0, self.stages - len(free))
        n = len(self.pool.vfs) + missing
        if missing and n > self.pool.num_devices:
            # validate BEFORE spawning: a fresh tenant registered here
            # would leak (params copy + a never-attachable fleet entry)
            raise ManagerError(
                f"scale_out: {n} VFs exceed the device budget "
                f"({self.pool.num_devices})")
        parked = sorted((tn for tn in self.tenants.values()
                         if tn.status in ("created", "detached")),
                        key=lambda tn: self._order[tn.tid])
        tn = parked[0] if parked else self._spawn_tenant()
        if not missing:
            if tn.gang_shells:
                self.mgr.attach_group(tn)
            else:
                self.mgr.attach(tn)
        else:
            self.mgr.reconf(n, new_tenants=[tn],
                            devices_per_vf=max(
                                1, self.pool.num_devices // n))
        # the new engine takes queued (not-yet-admitted) work off the
        # hottest engine immediately — otherwise it idles until the next
        # rebalance epoch while the hot queue keeps missing SLO
        hot = max((t for t in self.tenants.values()
                   if t.status == "running" and t.tid != tn.tid),
                  key=lambda t: (t.load, -self._order[t.tid]),
                  default=None)
        if hot is not None and hot.engine.queue:
            self.rebalance(hot.tid, tn.tid, migrate=False)
        return tn.tid

    def scale_in(self, tid: str) -> str:
        """Park an engine: journaled detach (state snapshots to disk,
        the VF keeps its devices and becomes attachable). A BUSY engine
        drains first — in-flight chunked prefills abort back to its
        queue (they have emitted nothing), queued requests resubmit to
        running siblings under the SLO admission bound, and active
        decode slots LIVE-MIGRATE (journaled KV hand-off, token streams
        unchanged). Typed refusal when no sibling has the capacity —
        every request the drain already moved stays live on its new
        engine, nothing strands."""
        tn = self.tenants[tid]
        if tn.status != "running":
            raise ManagerError(f"scale_in: {tid} is {tn.status}")
        if tn.load:      # load = queued + in-flight prefill + active slots
            self._drain_for_scale_in(tn)
        self.mgr.detach(tn)
        return tid

    def _drain_for_scale_in(self, tn: EngineTenant) -> None:
        sibs = [t for t in self.tenants.values()
                if t.status == "running" and t.tid != tn.tid]
        if not sibs:
            raise ManagerError(
                f"scale_in: {tn.tid} is busy (load {tn.load}) and has "
                "no running sibling to drain to")

        def best():
            return min(sibs, key=lambda t: (t.load, self._order[t.tid]))
        # chunked prefills re-queue deterministically (nothing emitted)
        tn.engine.abort_prefill_jobs()
        while tn.engine.queue:
            pick = best()
            if pick.load >= self.slo_max_load:
                raise ManagerError(
                    f"scale_in: no sibling admission capacity for "
                    f"{tn.tid}'s queued requests (best {pick.tid}@"
                    f"{pick.load} >= {self.slo_max_load})")
            pick.engine.submit(tn.engine.queue.pop())
            self.telemetry.record_submit(pick.tid)
        # active decode slots: journaled live migration with bounded
        # per-sibling retries (migrate_request defragments in between)
        while (rid := tn.peek_migratable()) is not None:
            for t in sorted(sibs,
                            key=lambda t: (t.load, self._order[t.tid])):
                if (t.load < self.slo_max_load and
                        self.migrate_request(tn.tid, t.tid,
                                             rid) is not None):
                    break
            else:
                raise ManagerError(
                    f"scale_in: no sibling has KV capacity for in-"
                    f"flight request {rid} on {tn.tid}")
        if tn.load:
            # a dense engine (no paged KV) cannot ship its active slots
            raise ManagerError(
                f"scale_in: {tn.tid} still busy after drain "
                f"(load {tn.load}) — active work is not migratable")

    def rebalance(self, src: str, dst: str,
                  migrate: Optional[bool] = None) -> int:
        """Move queued (not-yet-admitted) requests from the hot engine to
        the cold one — they have emitted nothing, so replacement is
        token-identical — then live-migrate in-flight ones while the gap
        stays, then migrate the hot victim onto fresh devices (pause ->
        reallocate -> unpause keeps its in-flight batch). Returns the
        number of requests moved."""
        s, d = self.tenants[src], self.tenants[dst]
        moved = 0
        while s.engine.queue and s.load - d.load > 1:
            # steal from the BACK: the oldest requests keep their engine
            d.engine.submit(s.engine.queue.pop())
            moved += 1
        # queue-stealing can't close the gap when the hot engine's load
        # is IN-FLIGHT: live-migrate decode slots hot -> cold through the
        # journaled op. An abort (target KV full even after its defrag
        # retries) ends the steal — the request stays live on the source.
        while (s.status == "running" and d.status == "running"
               and s.load - d.load > 1
               and s.peek_migratable() is not None):
            if self.migrate_request(src, dst) is None:
                break
            moved += 1
        if migrate is None:
            migrate = (self.autoscale_config.rebalance_migrate
                       if self.autoscale_config else True)
        if migrate and s.status == "running":
            self.mgr.migrate(s)
        return moved

    def recover_engine(self, tid: str) -> dict:
        """An engine CRASHED mid-serving (its device state is gone):
        re-home every live request onto running siblings by
        deterministic recompute — emitted tokens are cleared and
        regenerate bit-identically from the prompt (the counter-seeded
        sampler keys on (seed, rid, position), not on engine identity)
        — then reset the victim to a clean, re-servable state. Typed
        refusal BEFORE any mutation when the siblings lack admission
        capacity, so the caller can scale out first and retry."""
        tn = self.tenants[tid]
        eng = tn.engine
        live = [r for r in ([j.req for j in eng._jobs.values()]
                            + list(eng.queue)
                            + [r for r in eng.active if r is not None])
                if not r.done]
        sibs = [t for t in self.tenants.values()
                if t.status == "running" and t.tid != tid]
        if live and not sibs:
            raise ManagerError(
                f"recover_engine: {tid} holds {len(live)} live requests "
                "and no sibling is running")
        headroom = sum(max(0, self.slo_max_load - t.load) for t in sibs)
        if len(live) > headroom:
            raise ManagerError(
                f"recover_engine: siblings have admission headroom for "
                f"{headroom} requests, {tid} holds {len(live)}")
        eng.reset_after_crash()
        self._harvested[tid] = 0
        rehomed = []
        for req in live:
            req.out.clear()
            req.t_tok.clear()
            pick = min(sibs, key=lambda t: (t.load, self._order[t.tid]))
            pick.engine.submit(req)
            self.telemetry.record_submit(pick.tid)
            rehomed.append((req.rid, pick.tid))
        return {"tid": tid, "rehomed": rehomed}

    def query(self) -> dict:
        return {"manager": self.mgr.query(),
                "engines": {tid: tn.query()
                            for tid, tn in self.tenants.items()},
                "telemetry": self.telemetry.describe(),
                "rejections": self.rejected_total,
                "autoscale_actions": (len(self.autoscaler.history)
                                      if self.autoscaler else 0)}

    def reshape_engine(self, tid: str, width: int) -> dict:
        """Re-instantiate a gang engine at ``width`` stages via the
        journaled manager reshape — in-flight token streams unchanged
        (I10), the gang matching exactly one registered template before
        and after (I14)."""
        tn = self.tenants[tid]
        if not tn.gang_shells:
            raise ManagerError(
                f"reshape_engine: {tid} is not a pipeline gang")
        return self.mgr.reshape(tn, width)

    def handle_vf_loss(self, tid: str, vf_id: str) -> dict:
        """A gang member's VF died (device failure): shed exactly that
        stage and re-instantiate the engine at K-1 through the same
        journaled reshape, so the fallback is crash-covered and the
        surviving K-1 stages keep every request byte. The lead's own VF
        dying is a full engine crash — that path is ``recover_engine``."""
        tn = self.tenants[tid]
        shell = next((s for s in tn.gang_shells if s.vf_id == vf_id), None)
        if shell is None:
            raise ManagerError(
                f"handle_vf_loss: {vf_id} backs no active stage of {tid}")
        return self.mgr.reshape(tn, tn.stage_width - 1, drop=shell.tid)
