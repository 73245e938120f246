"""ScenarioRunner — executes a generated scenario against the real stack
(mirrors ``repro.sim.harness``).

One runner = one scenario = one fresh ``DevicePool`` (simulated device
tokens ``simdev{i}``), ``SVFFManager`` (with the configured placement
policy), real ``StagingEngine`` / ``RecordStore`` / ``CheckpointStore``
on a throwaway workdir, and sim tenants whose state lives on ``device``
(the card by default). After EVERY op — successful or rejected —
``check_invariants`` runs and every running tenant's state leaves must be
tensors on ``device``; any violation raises ``InvariantViolation``
tagged ``seed=<s> op#<i>``, which reproduces the failure exactly:

    ScenarioRunner(ScenarioConfig(seed=<s>, policy=<p>)).run()

Expected rejections (admission failures, illegal transitions, I/O on a
paused device, ...) are recorded per-op — never exceptions — because the
property under test is that a rejected op is ATOMIC: the system state it
leaves behind still satisfies every invariant.

``autoscale`` ops run one policy-loop epoch (``core.autoscaler``) over
the serving tenants and execute its action through journaled manager ops,
with I11 checked after the op; ``migrate_request`` ops live-migrate one
in-flight request between two running serving tenants. The pipeline gang
lead ``pg0`` (a ``SimPipelineTenant``, its shells registered beside it)
attaches whole through ``attach_group``, and ``reshape`` ops change its
width through the journaled ``SVFFManager.reshape``, with I14 checked
after every op.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
import zlib
from typing import Optional

import torch

from repro_torch.core.autoscaler import (Autoscaler, AutoscaleConfig,
                                         EngineStats, TelemetrySnapshot)
from repro_torch.core.errors import ManagerError
from repro_torch.core.fault import Supervisor
from repro_torch.core.manager import SVFFManager
from repro_torch.core.pause import PauseError
from repro_torch.core.pool import DevicePool, PoolError
from repro_torch.core.records import RecordError
from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.staging import StagingEngine
from repro_torch.core.tenant import DevicePausedError
from repro_torch.core.vf import VFState, VFTransitionError
from repro_torch.device import resolve_device
from repro_torch.sim.chaos import _fire, recover_manager
from repro_torch.sim.clock import VirtualClock
from repro_torch.serve.paged import CacheExhausted
from repro_torch.sim.invariants import (InvariantViolation, check_autoscale,
                                        check_invariants,
                                        check_pause_timings, check_timings)
from repro_torch.sim.scenario import Op, ScenarioConfig, generate_scenario
from repro_torch.sim.tenant import (SimPipelineTenant, SimServeTenant,
                                    SimTenant)
from repro_torch.tree import tree_leaves

#: exception types an op may legally be rejected with (atomically).
#: All TYPED: a blanket KeyError here once masked real bugs (e.g. a
#: missing-snapshot lookup) as "expected rejections" — the manager raises
#: ManagerError/UnknownTenantError for those paths instead.
REJECTIONS = (PoolError, PauseError, VFTransitionError, DevicePausedError,
              RecordError, ManagerError)


@dataclasses.dataclass
class OpResult:
    op: Op
    status: str                 # ok | rejected
    error: Optional[str] = None
    virtual_t: float = 0.0


@dataclasses.dataclass
class ScenarioResult:
    config: ScenarioConfig
    ops: list[OpResult]
    reconf_timings: list[dict]
    wall_seconds: float
    virtual_seconds: float
    final: dict

    @property
    def num_ok(self) -> int:
        return sum(1 for r in self.ops if r.status == "ok")

    @property
    def num_rejected(self) -> int:
        return sum(1 for r in self.ops if r.status == "rejected")

    def fingerprint(self) -> str:
        """Digest of the full outcome — equal across replays of a seed."""
        parts = []
        for r in self.ops:
            tag = f"{r.op.kind}:{r.op.tenant}:{r.status}"
            if r.op.point:
                tag += f":{r.op.point}"
            parts.append(tag)
        for tid in sorted(self.final["tenants"]):
            q = self.final["tenants"][tid]
            parts.append(f"{tid}={q['status']}@{q['steps_done']}")
        return f"{zlib.crc32('|'.join(parts).encode()):08x}"


#: policy-loop sizing for sim serving tenants (SimServeTenant has 2 slots
#: and bursts of up to ~12, so hot = load >= ceil(0.75 * 6) = 5)
SIM_SLO_MAX_LOAD = 6
#: sv0 is the scenario's fixed traffic ingress (serve_submit/serve_step
#: target it by name), so it is pinned against scale_in
SIM_AUTOSCALE = AutoscaleConfig(hysteresis=1, cooldown=1,
                                rebalance_gap=4, max_engines=4,
                                pinned=("sv0",))


class ScenarioRunner:
    def __init__(self, cfg: ScenarioConfig, workdir: Optional[str] = None,
                 device="cuda"):
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        self.clock = VirtualClock()
        self.mgr: Optional[SVFFManager] = None
        self.sup: Optional[Supervisor] = None
        self.tenants: dict = {}
        self.expected_steps: dict[str, int] = {}
        autocfg = SIM_AUTOSCALE
        if cfg.migrate_rate > 0:
            # with migration traffic the scenario attaches sv1 as a
            # fixed migration target — pin it like sv0 so the autoscaler
            # can't scale it in under the generator's validity model
            # (which schedules ops against sv1)
            autocfg = dataclasses.replace(SIM_AUTOSCALE,
                                          pinned=("sv0", "sv1"))
        self.autoscaler = Autoscaler(autocfg)
        self._as_epoch = 0
        self._last_autoscale = None       # pending I11 check

    # ----------------------------------------------------------------- ops
    def _tenant(self, tid: str):
        if tid not in self.tenants:
            if tid.startswith("pg"):
                # pipeline gang lead: a serving tenant that spans up to
                # max_width VFs; its shell members register alongside it
                # so crash recovery and the step-counter check see them
                lead = SimPipelineTenant(
                    tid, seed=self.cfg.seed, clock=self.clock,
                    placement=self.cfg.policy,
                    leaf_size=self.cfg.leaf_size, device=self.device)
                self.tenants[tid] = lead
                for sh in lead.gang_shells:
                    self.tenants[sh.tid] = sh
                    self.expected_steps[sh.tid] = 0
            elif tid.startswith("sv"):
                # serving tenants: paged toy engine, I10-checked outputs
                self.tenants[tid] = SimServeTenant(
                    tid, seed=self.cfg.seed, clock=self.clock,
                    placement=self.cfg.policy, device=self.device)
            else:
                self.tenants[tid] = SimTenant(
                    tid, seed=self.cfg.seed * 1009 + len(self.tenants),
                    leaf_size=self.cfg.leaf_size, clock=self.clock,
                    placement=self.cfg.policy, device=self.device)
            self.expected_steps[tid] = 0
        return self.tenants[tid]

    def _apply(self, op: Op) -> Optional[dict]:
        mgr, clock = self.mgr, self.clock
        if op.kind == "init":
            devices = tuple(f"simdev{i}"
                            for i in range(self.cfg.num_devices))
            pool = DevicePool(devices=devices, max_vfs=self.cfg.max_vfs)
            self.mgr = SVFFManager(pool, workdir=self._wd,
                                   staging=StagingEngine(num_queues=2),
                                   scheduler=self.cfg.policy)
            self.sup = Supervisor(self.mgr, clock=self.clock.now)
            tns = [self._tenant(f"vm{i}") for i in range(op.num_tenants)]
            self.mgr.init(op.num_vfs, tns,
                          devices_per_vf=op.devices_per_vf)
            clock.advance(0.05)                 # rescan + partition cost
            return None
        assert mgr is not None, "scenario must start with init"
        if op.kind == "attach":
            tn = self._tenant(op.tenant)
            if getattr(tn, "gang_shells", None):
                mgr.attach_group(tn)     # lead + shells, atomically
            else:
                mgr.attach(tn)
        elif op.kind == "reshape":
            # journaled gang width change: attach/detach shell members
            # to reach op.num_vfs stages, then apply the template
            mgr.reshape(self._tenant(op.tenant), op.num_vfs)
            clock.advance(0.02)
        elif op.kind == "detach":
            mgr.detach(self._tenant(op.tenant))
            clock.advance(0.02)
        elif op.kind == "pause":
            t = mgr.pause(self._tenant(op.tenant))
            check_pause_timings(t, live=False)
            clock.advance(0.01)
        elif op.kind == "pause_live":
            tn = self._tenant(op.tenant)
            stepped = [0]

            def _live_step():
                # the tenant keeps working between pre-copy rounds — the
                # whole point of the live path (invariant I4 then proves
                # those steps survive the pause bit-exactly)
                tn.run_steps(1)
                stepped[0] += 1
            t = mgr.pause_live(tn, rounds=2, step_fn=_live_step)
            self.expected_steps[op.tenant] += stepped[0]
            check_pause_timings(t, live=True)
            clock.advance(0.01)
        elif op.kind == "unpause":
            mgr.unpause(self._tenant(op.tenant))
            clock.advance(0.01)
        elif op.kind == "reconf":
            timings = mgr.reconf(op.num_vfs,
                                 devices_per_vf=op.devices_per_vf)
            check_timings(timings)
            clock.advance(0.05)
            return timings
        elif op.kind == "migrate":
            mgr.migrate(self._tenant(op.tenant))
            clock.advance(0.02)
        elif op.kind == "fault":
            tn = self._tenant(op.tenant)
            tn.inject_failure()
            pre_running = {t for t, tn2 in self.tenants.items()
                           if tn2.status == "running" and t in mgr.tenants}
            self.sup.run_round(1)
            # every healthy running tenant advanced one step; the faulted
            # one raised before stepping and was migrated with its state
            for t in pre_running:
                if t != op.tenant:
                    self.expected_steps[t] += 1
            kinds = [e["kind"] for e in self.sup.events[-2:]]
            if kinds != ["failure", "migrated"]:
                raise InvariantViolation(
                    f"fault on {op.tenant} not recovered: {kinds}")
        elif op.kind == "step":
            self._tenant(op.tenant).run_steps(op.steps)
            self.expected_steps[op.tenant] += op.steps
        elif op.kind == "serve_submit":
            # guest-side queueing — legal even while the engine is paused
            self._tenant(op.tenant).submit_burst(op.burst)
        elif op.kind == "serve_step":
            # the named tenant first — preserving the rejection behaviour
            # when it is paused — then every other running serving tenant
            self._tenant(op.tenant).run_steps(op.steps)
            self.expected_steps[op.tenant] += op.steps
            for tid in sorted(self.tenants):
                tn = self.tenants[tid]
                if (tid != op.tenant and tid.startswith("sv")
                        and tn.status == "running"):
                    tn.run_steps(op.steps)
                    self.expected_steps[tid] += op.steps
        elif op.kind == "crash":
            # kill the manager at the named crash point mid-trigger-op,
            # then rebuild it via SVFFManager.recover (with the I9
            # double-recovery check inside recover_manager)
            victim = self._tenant(op.tenant) if op.tenant else None
            stepped = _fire(mgr, op.trigger, op.point, victim)
            if op.tenant:
                self.expected_steps[op.tenant] += stepped
            self.mgr = recover_manager(mgr, self.tenants,
                                       policy=self.cfg.policy,
                                       workdir=self._wd, num_queues=2)
            self.sup = Supervisor(self.mgr, clock=self.clock.now)
            clock.advance(0.1)              # manager restart + recovery
        elif op.kind == "autoscale":
            self._autoscale_step()
            clock.advance(0.005)
        elif op.kind == "migrate_request":
            # deterministic pair pick among the running serving engines:
            # source = first (sorted) one with a migratable in-flight
            # request, target = first other running one. No such pair is
            # a no-op — the op is about what happens WHEN a migration
            # runs, not about manufacturing one — and a target-side
            # CacheExhausted is a clean journaled abort (the source keeps
            # serving, invariant I13 still checked after the op).
            svs = [tn for tn in self._serve_tenants()
                   if tn.status == "running"]
            src = next((tn for tn in svs
                        if tn.peek_migratable() is not None), None)
            dst = next((tn for tn in svs
                        if src is not None and tn.tid != src.tid), None)
            if src is not None and dst is not None:
                try:
                    mgr.migrate_request(src, dst)
                except CacheExhausted:
                    pass
                clock.advance(0.01)
        else:
            raise ValueError(f"unknown op {op.kind}")
        return None

    # ------------------------------------------------------- elastic plane
    def _serve_tenants(self) -> list:
        return [self.tenants[tid] for tid in sorted(self.tenants)
                if tid.startswith("sv")]

    def _autoscale_snapshot(self) -> TelemetrySnapshot:
        """Telemetry over the serving tenants: load = guest-side queue +
        in-flight slots. ``grow_budget`` is 0 — the sim's executor only
        takes the cheap path (attach to an existing free VF), it never
        runs a grow-reconf, and the planner must know that."""
        self._as_epoch += 1
        stats = []
        for tn in self._serve_tenants():
            queued = len(tn.queue) if tn.queue is not None else 0
            inflight = (sum(r is not None for r in tn.active)
                        if tn.active is not None else 0)
            stats.append(EngineStats(
                tid=tn.tid, index=int(tn.tid[2:] or 0), status=tn.status,
                load=queued + inflight, queue_depth=queued,
                inflight=inflight, prefill_jobs=0))
        pool = self.mgr.pool
        free_vfs = sum(1 for vf in pool.vfs.values()
                       if vf.state == VFState.DETACHED
                       and vf.owner is None and vf.devices)
        return TelemetrySnapshot(
            epoch=self._as_epoch, slo_max_load=SIM_SLO_MAX_LOAD,
            engines=tuple(stats), free_vfs=free_vfs, grow_budget=0)

    def _autoscale_step(self):
        """One policy-loop epoch over the serving tenants. The planned
        action is remembered for the I11 check that runs with the post-op
        invariants (so a violation carries the seed/op# tag), then
        executed through the ordinary journaled manager ops."""
        action = self.autoscaler.observe(self._autoscale_snapshot())
        if action is None:
            return
        self._last_autoscale = (action, self.autoscaler.cfg)
        if action.kind == "scale_out":
            # prefer re-attaching a previously scaled-in tenant (its
            # state restores from the detach snapshot) over minting one
            parked = [tn.tid for tn in self._serve_tenants()
                      if tn.status == "detached"]
            nxt = 1 + max((int(tn.tid[2:] or 0)
                           for tn in self._serve_tenants()), default=0)
            new = self._tenant(parked[0] if parked else f"sv{nxt}")
            self.mgr.attach(new)

            # like the fleet: the fresh engine immediately takes queued
            # work off the hottest serving tenant (queued requests have
            # emitted nothing, so moving them is I10-safe)
            def _load(tn):
                return (len(tn.queue)
                        + sum(r is not None for r in tn.active))
            hot = max((tn for tn in self._serve_tenants()
                       if tn.status == "running" and tn.tid != new.tid),
                      key=_load, default=None)
            while (hot is not None and hot.queue
                   and _load(hot) - _load(new) > 1):
                new.queue.append(hot.queue.pop())
        elif action.kind == "scale_in":
            self.mgr.detach(self.tenants[action.victim])
        else:                                     # rebalance
            src = self.tenants[action.victim]
            dst = self.tenants[action.target]

            def _gap(a, b):
                return (len(a.queue)
                        + sum(r is not None for r in a.active)
                        - len(b.queue)
                        - sum(r is not None for r in b.active))
            while src.queue and _gap(src, dst) > 1:
                dst.queue.append(src.queue.pop())
            # queue-stealing alone can't close the gap when the hot
            # engine's load is IN-FLIGHT: steal live requests through the
            # journaled migration op. CacheExhausted (target KV full) or
            # a manager refusal ends the steal cleanly — the request
            # stays live on the source.
            while (_gap(src, dst) > 1
                   and src.peek_migratable() is not None):
                try:
                    self.mgr.migrate_request(src, dst)
                except (CacheExhausted, ManagerError):
                    break
            self.mgr.migrate(src)

    # ----------------------------------------------------------------- run
    def run(self) -> ScenarioResult:
        make_scheduler(self.cfg.policy)     # fail fast on a policy typo
        ops = generate_scenario(self.cfg)
        self._wd = self.workdir or tempfile.mkdtemp(prefix="svff_sim_")
        results: list[OpResult] = []
        reconf_timings: list[dict] = []
        t0 = time.perf_counter()
        try:
            for i, op in enumerate(ops):
                try:
                    timings = self._apply(op)
                    if timings is not None:
                        reconf_timings.append(timings)
                    results.append(OpResult(op, "ok",
                                            virtual_t=self.clock.now()))
                    self.clock.stamp("ok", op=op.kind, tenant=op.tenant)
                except REJECTIONS as e:
                    if op.kind == "init":
                        raise    # a scenario with no system is no scenario
                    results.append(OpResult(op, "rejected", error=repr(e),
                                            virtual_t=self.clock.now()))
                    self.clock.stamp("rejected", op=op.kind,
                                     tenant=op.tenant)
                try:
                    check_invariants(self.mgr)
                    self._check_step_counters()
                    self._check_placement()
                    if self._last_autoscale is not None:
                        act, acfg = self._last_autoscale
                        self._last_autoscale = None
                        check_autoscale(act, acfg)      # I11
                except InvariantViolation as e:
                    raise InvariantViolation(
                        f"seed={self.cfg.seed} policy={self.cfg.policy} "
                        f"op#{i} {op}: {e}") from e
            final = self.mgr.query()
        finally:
            if self.workdir is None:
                shutil.rmtree(self._wd, ignore_errors=True)
        return ScenarioResult(
            config=self.cfg, ops=results, reconf_timings=reconf_timings,
            wall_seconds=time.perf_counter() - t0,
            virtual_seconds=self.clock.now(), final=final)

    def _check_placement(self):
        """Every running tenant's state leaves are tensors on the runner's
        device (an attribute read, no sync)."""
        for tid, tn in self.tenants.items():
            if tn.status != "running":
                continue
            for x in tree_leaves(tn.export_state()):
                if (not isinstance(x, torch.Tensor)
                        or x.device.type != self.device.type):
                    raise InvariantViolation(
                        f"{tid}: a state leaf is not a tensor on "
                        f"{self.device}")

    def _check_step_counters(self):
        for tid, want in self.expected_steps.items():
            got = self.tenants[tid].steps_done
            if got != want:
                raise InvariantViolation(
                    f"step counter drift for {tid}: {got} != {want}")


def run_scenario(seed: int, policy: str = "first_fit", device="cuda",
                 **kw) -> ScenarioResult:
    """Convenience: run one seeded scenario, return its result."""
    return ScenarioRunner(ScenarioConfig(seed=seed, policy=policy, **kw),
                          device=device).run()
