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

One card is one torch device: every engine of the fleet computes on the
fleet's ``device``, and the pool's slots (``fleetdev0``, ...) are logical,
as in the JAX fleet. A paused or detached engine holds no device memory:
``EngineTenant.suspend`` and ``detach`` drop the engine's params, their
compute copy and its page pools, and ``resume`` (or an attach from disk)
rebuilds them from the snapshot.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: the autoscaler and the elastic fleet (``autoscale``,
``spare_engines``, ``telemetry_snapshot``, ``autoscale_step``,
``scale_out``, ``scale_in``, ``rebalance``), request migration and engine
recovery (``migrate_request``, ``recover_engine``, ``handle_vf_loss``),
and pipeline-stage engines (``stages > 1``, ``reshape_engine``).
"""
from __future__ import annotations

import collections
import tempfile
import types
from typing import Optional

import numpy as np
import torch

from repro_torch.core.manager import SVFFManager
from repro_torch.core.pool import DevicePool
from repro_torch.core.tenant import DevicePausedError
from repro_torch.core.vf import VirtualFunction
from repro_torch.device import resolve_device
from repro_torch.serve.engine import DrainResult, Request, ServeEngine
from repro_torch.serve.paged import RequestRejected
from repro_torch.serve.telemetry import MetricsBus
from repro_torch.tree import tree_map, tree_to

_AUTOSCALE = ("is not ported yet (ROADMAP Queue 1 item 11: the autoscaler "
              "and elastic fleet, core/autoscaler.py)")
_MIGRATION = ("is not ported yet (ROADMAP Queue 1 item 12: fleet request "
              "migration and engine recovery)")
_STAGES = ("is not ported yet (ROADMAP Queue 1 item 13: pipeline-stage "
           "engines and gang ops)")


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
        # a single-VF engine is no gang lead (the manager dispatches on
        # the truthiness of gang_shells)
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

    def _drop_device_state(self):
        """Let go of every device tensor the engine holds — params, their
        compute-dtype copy and the page pools — so that, with the exported
        tree and the staging memo dropped by the pause/detach path, the
        card's memory is free ("exit from the IOMMU group")."""
        eng = self.engine
        eng.pause()
        eng.params = eng._cparams = eng._cache = None

    def suspend(self):
        self._drop_device_state()
        self.status = "paused"

    def resume(self, state, vf: VirtualFunction):
        self.status = "running"
        self.bind(vf, state=state)

    def detach(self):
        self._drop_device_state()
        self.vf_id = None
        self.status = "detached"

    # -- introspection -------------------------------------------------------
    @property
    def load(self) -> int:
        """Requests this engine is responsible for right now."""
        eng = self.engine
        return len(eng.queue) + sum(r is not None for r in eng.active)

    def query(self) -> dict:
        return {"tenant": self.tid, "status": self.status,
                "vf": self.vf_id, "steps_done": self.steps_done,
                "workload": self.workload, "load": self.load,
                "exec_keys": [list(map(str, k)) for k in self._exec_cache]}


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
                 devices=None, device="cuda", autoscale=None,
                 spare_engines: int = 0, num_vfs: Optional[int] = None,
                 stages: int = 1):
        if autoscale is not None:
            raise NotImplementedError(f"autoscale {_AUTOSCALE}")
        if spare_engines:
            raise NotImplementedError(f"spare_engines {_AUTOSCALE}")
        if stages != 1:
            raise NotImplementedError(f"stages={stages} {_STAGES}")
        self.run = run
        self.device = resolve_device(device)
        self.slo_max_load = slo_max_load
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
        tns = [self._spawn_tenant() for _ in range(num_engines)]
        self.mgr.init(max(num_vfs or num_engines, num_engines), tns)
        self.telemetry = MetricsBus()
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
        eng = ServeEngine(self.run, tree_to(self._params_src, self.device,
                                            copy=True),
                          device=self.device, **self._engine_kw)
        tn = EngineTenant(f"serve{i}", eng, placement=self._policy)
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
                    tn.engine.queue for tn in self.tenants.values()
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

    def query(self) -> dict:
        return {"manager": self.mgr.query(),
                "engines": {tid: tn.query()
                            for tid, tn in self.tenants.items()},
                "telemetry": self.telemetry.describe(),
                "rejections": self.rejected_total}

    # -- not ported yet -------------------------------------------------------
    def autoscale_step(self):
        raise NotImplementedError(f"autoscale_step {_AUTOSCALE}")

    def telemetry_snapshot(self):
        raise NotImplementedError(f"telemetry_snapshot {_AUTOSCALE}")

    def scale_out(self):
        raise NotImplementedError(f"scale_out {_AUTOSCALE}")

    def scale_in(self, tid: str):
        raise NotImplementedError(f"scale_in {_AUTOSCALE}")

    def rebalance(self, src: str, dst: str, migrate=None):
        raise NotImplementedError(f"rebalance {_AUTOSCALE}")

    def migrate_request(self, src: str, dst: str, rid=None, *, retries=2):
        raise NotImplementedError(f"migrate_request {_MIGRATION}")

    def recover_engine(self, tid: str):
        raise NotImplementedError(f"recover_engine {_MIGRATION}")

    def handle_vf_loss(self, tid: str, vf_id: str):
        raise NotImplementedError(f"handle_vf_loss {_MIGRATION}")

    def reshape_engine(self, tid: str, width: int):
        raise NotImplementedError(f"reshape_engine {_STAGES}")
