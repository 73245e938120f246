"""Autoscaler — the elastic SLO control plane's policy loop (mirrors
``repro.core.autoscaler``: the JAX package's module is standard-library
only, and the port keeps its own copy).

The paper's automation story ends at "reconfigure when asked"; SYNERGY
and Virtio-FPGA make the case that FPGA virtualization pays off when a
scheduler *oversubscribes and rebalances dynamically*. This module closes
that loop: a telemetry snapshot of the serving fleet goes in, at most one
reconfiguration action comes out, and the executor (``ServeFleet`` for
real engines, the scenario harness for sim tenants) applies it through
the EXISTING journaled manager ops — attach / detach / reconf / migrate —
so crash recovery covers autoscaler-initiated actions for free.

Action kinds:

  scale_out   spawn (or re-attach a parked) engine tenant on a fresh VF —
              the cheap path attaches to an existing detached VF, the
              grow path runs the paper's full reconf cycle (+1 VF)
  scale_in    drain + detach an IDLE engine; its state parks on disk and
              its VF (still holding devices, SR-IOV semantics) becomes
              the next scale_out's cheap path
  rebalance   pick the most-loaded / least-loaded running pair, move
              queued (not-yet-admitted) requests hot -> cold — requests
              that have emitted nothing are free to move (I10-safe) —
              then live-migrate IN-FLIGHT requests through the journaled
              request-migration op (KV block chains ship hot -> cold,
              token streams unchanged), and finally migrate the hot
              victim via pause -> fresh devices -> unpause without
              dropping its in-flight batch
  reshape     change a pipeline gang's stage width K -> K±1 through the
              journaled reshape op: grow the hottest gang when the engine
              count is maxed but VFs remain; shrink a gang whose MEASURED
              schedule bubble shows it burning a VF on idle ticks

The policy is deliberately conservative and fully deterministic:

  * hysteresis — a condition must hold for ``hysteresis`` consecutive
    observation epochs before it triggers (one hot sample never scales);
  * cooldown — after any action the loop is silent for ``cooldown``
    epochs, so oscillating load cannot flap the fleet;
  * every ``Action`` carries the ``TelemetrySnapshot`` it was planned
    from, and ``justify_action`` re-derives the action's necessary
    conditions from that snapshot alone — invariant **I11** (sim) checks
    it after every autoscale op, so an action the telemetry does not
    support is a caught bug, not a silent misconfiguration.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """One engine's slice of a telemetry snapshot (cheap to build: counts
    and pre-aggregated window percentiles, no per-request data)."""
    tid: str
    index: int                  # creation order — the placement tie-break
    status: str                 # created|running|paused|detached
    load: int = 0               # queued + in-flight prefill + active slots
    queue_depth: int = 0
    inflight: int = 0
    prefill_jobs: int = 0
    ttft_p95_ms: float = 0.0
    itl_p95_ms: float = 0.0
    rejected: int = 0           # fleet-side rejections attributed here
    # paged-KV cache pressure (zeros when the engine is dense): the pool
    # can thrash while queues stay short, so queue depth alone is blind
    cache_exhausted: int = 0    # cumulative CacheExhausted events
    defrag_events: int = 0      # cumulative production defragment() passes
    pages_in_use: int = 0       # allocator pages currently owned
    pages_free: int = 0         # allocator pages currently free
    # request live migration (zeros when the fleet never migrates):
    # attempts/outcomes are attributed to the SOURCE engine; stall ticks
    # count decode iterations a slot sat frozen mid-hand-off
    migrations_attempted: int = 0
    migrations_completed: int = 0
    migrations_aborted: int = 0
    migration_blocks_shipped: int = 0
    migration_stall_ticks: int = 0
    # pipeline width (1 for single-VF engines): the second action
    # dimension. ``stage_loads``/``bubble_frac`` are MEASURED from the
    # engine's GPipe schedule walls (runtime.pipeline.schedule_stats),
    # so a width action is justified by evidence, not geometry
    stage_width: int = 1
    stage_width_max: int = 1
    stage_loads: tuple = ()
    bubble_frac: float = 0.0


@dataclasses.dataclass(frozen=True)
class TelemetrySnapshot:
    """What the policy loop reads: per-engine stats plus the capacity
    facts (free VFs / growth headroom) that gate scale-out."""
    epoch: int
    slo_max_load: int
    engines: tuple = ()
    free_vfs: int = 0           # detached, unowned, device-holding VFs
    grow_budget: int = 0        # extra VFs a reconf could still create
    rejected_recent: int = 0    # fleet-wide rejections since last snapshot
    age_s: float = 0.0          # age of the OLDEST evidence in this view
                                # (0 for a locally-built snapshot; the
                                # federation stamps replicated snapshots
                                # and a partition makes them grow old)

    def running(self) -> tuple:
        return tuple(e for e in self.engines if e.status == "running")

    def hot_threshold(self, cfg: "AutoscaleConfig") -> int:
        return max(1, math.ceil(cfg.scale_out_load * self.slo_max_load))

    def describe(self) -> dict:
        return {"epoch": self.epoch,
                "engines": {e.tid: e.load for e in self.engines},
                "free_vfs": self.free_vfs,
                "grow_budget": self.grow_budget}


@dataclasses.dataclass(frozen=True)
class AutoscaleAction:
    """One planned reconfiguration. ``snapshot`` is the evidence — I11
    re-derives the action's preconditions from it, nothing else."""
    kind: str                   # scale_out | scale_in | rebalance | reshape
    snapshot: TelemetrySnapshot
    victim: Optional[str] = None    # scale_in: engine to park;
                                    # rebalance/reshape: the engine acted on
    target: Optional[str] = None    # rebalance: the cold engine
    width: Optional[int] = None     # reshape: the new stage width K'
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    scale_out_load: float = 0.75    # hot = load >= this x slo_max_load
    rebalance_gap: int = 8          # hot-cold load gap that triggers a move
    hysteresis: int = 2             # consecutive epochs before acting
    cooldown: int = 4               # silent epochs after any action
    min_engines: int = 1
    max_engines: int = 8
    rebalance_migrate: bool = True  # migrate the hot victim after stealing
    pinned: tuple = ()              # engines never eligible for scale_in
                                    # (e.g. the fleet's ingress engine)
    reshape_bubble: float = 0.5     # shrink a gang when its MEASURED
                                    # schedule bubble reaches this share
    max_staleness_s: float = math.inf   # refuse to act on a snapshot whose
                                        # evidence is older than this (the
                                        # federation sets it so a partition
                                        # cannot drive scaling from a stale
                                        # replicated view — I11's age arm)


ACTION_KINDS = ("scale_out", "scale_in", "rebalance", "reshape")


def justify_action(action: AutoscaleAction,
                   cfg: AutoscaleConfig) -> Optional[str]:
    """Re-derive ``action``'s necessary conditions from the snapshot it
    carries; returns an error string when the telemetry does not support
    the action (the I11 violation text), else None. Deliberately
    stateless: hysteresis/cooldown are policy NICETIES, but an action is
    only ever legal if its instantaneous preconditions held in the
    snapshot it read."""
    snap = action.snapshot
    if snap.age_s > cfg.max_staleness_s:
        return (f"action planned from stale telemetry: age "
                f"{snap.age_s:.3f}s > bound {cfg.max_staleness_s:.3f}s")
    running = snap.running()
    by_tid = {e.tid: e for e in running}
    if action.kind == "scale_out":
        thr = snap.hot_threshold(cfg)
        if not any(e.load >= thr for e in running):
            return (f"scale_out with no engine at load >= {thr} "
                    f"(loads {[e.load for e in running]})")
        if snap.free_vfs <= 0 and snap.grow_budget <= 0:
            return "scale_out without a free VF or growth headroom"
        if len(running) >= cfg.max_engines:
            return (f"scale_out past max_engines={cfg.max_engines} "
                    f"({len(running)} running)")
    elif action.kind == "scale_in":
        e = by_tid.get(action.victim)
        if e is None:
            return f"scale_in victim {action.victim!r} not running"
        if e.load != 0 or e.prefill_jobs:
            return (f"scale_in of busy engine {e.tid} (load {e.load}, "
                    f"{e.prefill_jobs} prefill jobs)")
        if len(running) <= cfg.min_engines:
            return (f"scale_in below min_engines={cfg.min_engines}")
        if e.tid in cfg.pinned:
            return f"scale_in of pinned engine {e.tid}"
    elif action.kind == "rebalance":
        v, t = by_tid.get(action.victim), by_tid.get(action.target)
        if v is None or t is None:
            return (f"rebalance pair {action.victim!r}->{action.target!r} "
                    "not both running")
        if v.load - t.load < cfg.rebalance_gap:
            return (f"rebalance without imbalance: {v.tid}@{v.load} vs "
                    f"{t.tid}@{t.load} < gap {cfg.rebalance_gap}")
        if v.queue_depth <= 0 and v.inflight <= 0:
            # queued requests move for free; in-flight ones move through
            # the journaled request-migration op — either justifies it
            return (f"rebalance with nothing queued or in flight on "
                    f"{v.tid} to move")
    elif action.kind == "reshape":
        e = by_tid.get(action.victim)
        if e is None:
            return f"reshape victim {action.victim!r} not running"
        w = action.width
        if w is None or w < 1 or w == e.stage_width:
            return (f"reshape of {e.tid} to width {w!r} from "
                    f"{e.stage_width}")
        if w > e.stage_width_max:
            return (f"reshape of {e.tid} to width {w} past its "
                    f"template ceiling {e.stage_width_max}")
        if w > e.stage_width:
            thr = snap.hot_threshold(cfg)
            if e.load < thr:
                return (f"grow-reshape of {e.tid} at load {e.load} < "
                        f"hot threshold {thr}")
            if snap.free_vfs < w - e.stage_width:
                return (f"grow-reshape of {e.tid} needs "
                        f"{w - e.stage_width} free VF(s), have "
                        f"{snap.free_vfs}")
        else:
            # shrinking trades latency of a LIVE gang for capacity: only
            # measured idleness (bubble) or full idleness justifies it
            if e.bubble_frac < cfg.reshape_bubble and e.load != 0:
                return (f"shrink-reshape of busy {e.tid} with measured "
                        f"bubble {e.bubble_frac:.2f} < "
                        f"{cfg.reshape_bubble}")
    else:
        return f"unknown action kind {action.kind!r}"
    return None


class Autoscaler:
    """The decision loop: feed it one ``TelemetrySnapshot`` per epoch
    (``observe``), get back at most one ``AutoscaleAction``. Priority
    when several conditions hold: rebalance (cheapest — moves queued
    work) > scale_out (adds capacity) > scale_in (returns capacity);
    scale_in never fires while any engine is hot."""

    def __init__(self, cfg: Optional[AutoscaleConfig] = None):
        self.cfg = cfg or AutoscaleConfig()
        self.history: list[AutoscaleAction] = []
        self._cooldown = 0
        self._hot_streak = 0
        self._idle_streak: dict[str, int] = {}

    # ------------------------------------------------------------------
    def observe(self, snap: TelemetrySnapshot
                ) -> Optional[AutoscaleAction]:
        cfg = self.cfg
        if snap.age_s > cfg.max_staleness_s:
            # stale evidence plans nothing AND advances nothing: streaks
            # and cooldown freeze, so one fresh post-heal snapshot cannot
            # combine with pre-partition streak state to trigger an action
            return None
        running = snap.running()
        thr = snap.hot_threshold(cfg)
        hot = [e for e in running if e.load >= thr]

        # streak bookkeeping happens every epoch, cooldown or not, so a
        # condition that persists through the cooldown fires right after
        self._hot_streak = self._hot_streak + 1 if hot else 0
        live = set()
        for e in running:
            live.add(e.tid)
            idle = e.load == 0 and e.prefill_jobs == 0
            self._idle_streak[e.tid] = (
                self._idle_streak.get(e.tid, 0) + 1 if idle else 0)
        for tid in list(self._idle_streak):
            if tid not in live:
                del self._idle_streak[tid]

        if self._cooldown > 0:
            self._cooldown -= 1
            return None

        action = self._plan(snap, running, hot, thr)
        if action is not None:
            self._cooldown = cfg.cooldown
            self._hot_streak = 0
            self.history.append(action)
        return action

    # ------------------------------------------------------------------
    def _plan(self, snap, running, hot, thr) -> Optional[AutoscaleAction]:
        cfg = self.cfg
        if hot and self._hot_streak >= cfg.hysteresis:
            hottest = max(hot, key=lambda e: (e.load, -e.index))
            if len(running) >= 2:
                coldest = min(running, key=lambda e: (e.load, e.index))
                if (hottest.load - coldest.load >= cfg.rebalance_gap
                        and (hottest.queue_depth > 0
                             or hottest.inflight > 0)):
                    return AutoscaleAction(
                        "rebalance", snap, victim=hottest.tid,
                        target=coldest.tid,
                        reason=(f"{hottest.tid}@{hottest.load} vs "
                                f"{coldest.tid}@{coldest.load} "
                                f">= gap {cfg.rebalance_gap}"))
            if (len(running) < cfg.max_engines
                    and (snap.free_vfs > 0 or snap.grow_budget > 0)):
                return AutoscaleAction(
                    "scale_out", snap,
                    reason=(f"{hottest.tid} at load {hottest.load} >= "
                            f"hot threshold {thr}"))
            # engine count maxed but free VFs remain: widen the hottest
            # gang instead (one more pipeline stage absorbs the load
            # without another engine's params copy)
            wide = [e for e in hot if e.stage_width < e.stage_width_max]
            if snap.free_vfs > 0 and wide:
                victim = max(wide, key=lambda e: (e.load, -e.index))
                return AutoscaleAction(
                    "reshape", snap, victim=victim.tid,
                    width=victim.stage_width + 1,
                    reason=(f"{victim.tid} at load {victim.load} >= "
                            f"{thr} with engines maxed; widening "
                            f"K={victim.stage_width}->"
                            f"{victim.stage_width + 1}"))
            return None
        if not hot:
            # a gang whose MEASURED schedule bubble crossed the threshold
            # is burning a VF on idle ticks: narrow it first — cheaper
            # than parking a whole engine, and the freed VF becomes the
            # next scale_out/grow-reshape's cheap path
            bubbly = [e for e in running
                      if e.stage_width > 1
                      and e.bubble_frac >= cfg.reshape_bubble]
            if bubbly:
                victim = max(bubbly,
                             key=lambda e: (e.bubble_frac, -e.index))
                return AutoscaleAction(
                    "reshape", snap, victim=victim.tid,
                    width=victim.stage_width - 1,
                    reason=(f"{victim.tid} measured bubble "
                            f"{victim.bubble_frac:.2f} >= "
                            f"{cfg.reshape_bubble}; narrowing "
                            f"K={victim.stage_width}->"
                            f"{victim.stage_width - 1}"))
        if not hot and len(running) > cfg.min_engines:
            idle = [e for e in running
                    if e.tid not in cfg.pinned
                    and self._idle_streak.get(e.tid, 0) >= cfg.hysteresis]
            if idle:
                # park the NEWEST idle engine: the oldest engines carry
                # the longest-lived executables/caches and stay
                victim = max(idle, key=lambda e: e.index)
                return AutoscaleAction(
                    "scale_in", snap, victim=victim.tid,
                    reason=(f"{victim.tid} idle for >= "
                            f"{cfg.hysteresis} epochs"))
        return None
