"""VirtualClock — deterministic time for the scenario simulator (a copy of
``repro.sim.clock``).

Real SVFF timings (Table II) come from ``time.perf_counter``; a property
harness cannot assert on those. The simulator therefore threads a virtual
clock through every simulated component: operations *advance* it by
modelled costs, and the event log is stamped in virtual seconds, so the
same seed always yields the same timeline.
"""
from __future__ import annotations


class VirtualClock:
    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self.events: list[dict] = []

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError(f"clock cannot go backwards ({seconds})")
        self._now += seconds
        return self._now

    def stamp(self, kind: str, **info) -> dict:
        ev = {"t": self._now, "kind": kind, **info}
        self.events.append(ev)
        return ev
