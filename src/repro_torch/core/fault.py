"""Fault tolerance: heartbeats, straggler detection, automatic recovery —
and the crash-injection plane (a copy of ``repro.core.fault``).

At 1000+ node scale, slow or dead workers are routine. The SVFF mechanism
gives a clean recovery primitive: a straggling tenant is *paused* (its
state leaves the sick devices) and *unpaused* onto healthy ones — the
tenant's loop never observes a teardown, exactly like a guest surviving a
reconfiguration.

Crash plane
-----------
``crashpoint(name)`` marks a named crash window in the manager/staging
stack. In production it is a no-op; a test arms one point at a time via
``crash_plane.arm(name)`` and the next execution of that window raises
``InjectedCrash`` — modelling the management process dying there. The
test then rebuilds a manager with ``SVFFManager.recover`` and checks
the state it recovered to. This module is intentionally a leaf (no manager
import at module scope) so every core module can call ``crashpoint``.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


# ---------------------------------------------------------------------------
# crash injection
# ---------------------------------------------------------------------------
class InjectedCrash(RuntimeError):
    """Raised at an armed crash point — the management plane 'dies' here.

    Deliberately NOT a subclass of any rejection type: an injected crash
    must never be absorbed as an "expected rejection"; it either reaches
    the crash handler or fails the test.
    """

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point


class CrashPlane:
    """One-shot crash-point trigger. ``arm(name)`` primes the plane; the
    next ``fire(name)`` for that point disarms it and raises
    ``InjectedCrash`` (one crash per arm, so recovery code re-entering the
    same window does not crash again). ``hits`` counts every window
    executed while armed — tests use it to prove a point was reached."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self.armed: Optional[str] = None
        self.fired: Optional[str] = None
        self.hits: list[str] = []

    def arm(self, point: str) -> None:
        with self._lock:
            self.armed = point
            self.fired = None

    def disarm(self) -> None:
        with self._lock:
            self.armed = None

    def fire(self, point: str) -> None:
        # cheap unarmed fast path; the lock makes the one-shot exact even
        # when windows run on staging queue threads
        if self.armed is None:
            return
        with self._lock:
            if self.armed is None:
                return
            self.hits.append(point)
            if point != self.armed:
                return
            self.armed = None          # one-shot: recovery must not re-crash
            self.fired = point
        raise InjectedCrash(point)


#: process-wide plane; tests arm it
crash_plane = CrashPlane()


def crashpoint(name: str) -> None:
    """Named crash window — no-op unless the chaos plane armed ``name``."""
    crash_plane.fire(name)


# ---------------------------------------------------------------------------
# heartbeats / stragglers
# ---------------------------------------------------------------------------
@dataclass
class Heartbeat:
    # None = never beat; 0.0 is a VALID beat time under an injected
    # virtual clock
    last_beat: Optional[float] = None
    step_times: list = field(default_factory=list)

    def beat(self, step_time: float, now: float):
        self.last_beat = now
        self.step_times.append(step_time)
        if len(self.step_times) > 64:
            self.step_times = self.step_times[-64:]


class HeartbeatMonitor:
    """Tracks per-tenant step latencies; flags stragglers and the dead.

    ``clock`` is any zero-arg callable returning seconds (default wall
    clock); a simulation passes its virtual clock so dead/straggler
    thresholds are deterministic and testable."""

    def __init__(self, straggler_factor: float = 3.0,
                 dead_after_s: float = 30.0,
                 clock: Callable[[], float] = time.time):
        self.straggler_factor = straggler_factor
        self.dead_after_s = dead_after_s
        self.clock = clock
        self.beats: dict[str, Heartbeat] = {}

    def record(self, tenant_id: str, step_time: float):
        self.beats.setdefault(tenant_id, Heartbeat()).beat(step_time,
                                                          self.clock())

    def _median(self) -> Optional[float]:
        recent = [hb.step_times[-1] for hb in self.beats.values()
                  if hb.step_times]
        return statistics.median(recent) if recent else None

    def stragglers(self) -> list[str]:
        med = self._median()
        if med is None or med == 0:
            return []
        return [tid for tid, hb in self.beats.items()
                if hb.step_times and
                hb.step_times[-1] > self.straggler_factor * med]

    def dead(self) -> list[str]:
        now = self.clock()
        return [tid for tid, hb in self.beats.items()
                if hb.last_beat is not None
                and now - hb.last_beat > self.dead_after_s]


class Supervisor:
    """Runs tenants under monitoring; migrates stragglers automatically."""

    def __init__(self, manager, monitor: Optional[HeartbeatMonitor] = None,
                 clock: Callable[[], float] = time.time):
        self.manager = manager
        self.clock = clock
        self.monitor = monitor or HeartbeatMonitor(clock=clock)
        self.events: list[dict] = []

    def run_round(self, steps: int = 1) -> dict:
        """One supervision round: every running tenant advances `steps`;
        failures trigger migration; stragglers are rebound."""
        results = {}
        for tid, tn in list(self.manager.tenants.items()):
            if tn.status != "running":
                continue
            try:
                metrics = tn.run_steps(steps)
                self.monitor.record(tid, tn.step_times[-1])
                results[tid] = metrics
            except InjectedCrash:
                raise                                 # chaos: not a failure
            except RuntimeError as e:                 # device failure
                self.events.append({"kind": "failure", "tenant": tid,
                                    "err": str(e), "t": self.clock()})
                info = self.manager.migrate(tn)
                self.events.append({"kind": "migrated", "tenant": tid,
                                    **info})
                results[tid] = {"recovered": True}
        for tid in self.monitor.stragglers():
            tn = self.manager.tenants.get(tid)
            if tn is not None and tn.status == "running":
                self.events.append({"kind": "straggler", "tenant": tid,
                                    "t": self.clock()})
                info = self.manager.migrate(tn)
                self.events.append({"kind": "migrated", "tenant": tid,
                                    **info})
                self.monitor.beats.pop(tid, None)
        return results
