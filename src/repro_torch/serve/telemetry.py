"""MetricsBus — per-engine serve-plane telemetry (mirrors
``repro.serve.telemetry``).

The hot path (``ServeFleet.submit`` / ``step``) only ever appends to
bounded deques and bumps counters; all aggregation (sorting for
percentiles) is deferred to read time. Latencies are harvested from the
per-token wall timestamps the engine already records on each ``Request``
(``t_submit`` / ``t_tok``), so serving pays nothing extra for them.

The autoscaler reads the bus once an epoch (``ServeFleet.
telemetry_snapshot``). A pipeline gang's per-stage loads and measured
schedule bubble are mirrored here too (``record_stage_load``). A stamped
replica of the aggregated view (``replicate``) is what a federation
coordinator keeps per host (``ServeFleet.federation_snapshot``).
"""
from __future__ import annotations

import collections
import math
from typing import Iterable


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile over an unsorted iterable (0 when empty):
    the smallest element with at least ``q`` of the sample at or below
    it — 1-based rank ``ceil(q * n)``."""
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        return 0.0
    i = min(n - 1, max(0, math.ceil(q * n) - 1))
    return xs[i]


class MetricsBus:
    """Sliding-window fleet telemetry keyed by engine tid."""

    def __init__(self, window: int = 256):
        self.window = window
        self._ttft = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._itl = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._load = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self.submitted = collections.Counter()
        self.completed = collections.Counter()
        self.rejected = collections.Counter()
        # cache-pressure counters (absolute cumulative values mirrored
        # from each engine's stats, not deltas — record overwrites)
        self.cache_exhausted = collections.Counter()
        self.defrag_events = collections.Counter()
        # request live-migration counters, attributed to the SOURCE
        # engine (it initiated the hand-off); stall ticks are mirrored
        # from the engine like the cache counters above
        self.migrations_attempted = collections.Counter()
        self.migrations_completed = collections.Counter()
        self.migrations_aborted = collections.Counter()
        self.migration_blocks = collections.Counter()
        self.migration_stall_ticks = collections.Counter()
        # pipeline-stage telemetry (mirror-overwrite like the cache
        # counters): per-stage busy shares of the measured makespan and
        # the measured GPipe bubble fraction, from the engine's schedule
        # walls — empty/0 for single-VF engines
        self.stage_loads: dict = {}
        self.stage_bubble: dict = {}
        self._rejected_since_snapshot = 0
        # requests already harvested, keyed (rid, t_submit); pruned when
        # the owner engine's finished list is drained
        self._seen: dict[str, set] = collections.defaultdict(set)

    # -- hot path (O(1) appends) -------------------------------------------
    def record_submit(self, tid: str) -> None:
        self.submitted[tid] += 1

    def record_reject(self, tid: str) -> None:
        self.rejected[tid] += 1
        self._rejected_since_snapshot += 1

    def record_load(self, tid: str, load: int, queued: int) -> None:
        self._load[tid].append((load, queued))

    def record_cache_pressure(self, tid: str, exhausted: int,
                              defrags: int) -> None:
        """Mirror an engine's cumulative exhaustion/defrag counters: a
        fleet can have short queues yet be thrashing its paged pool."""
        self.cache_exhausted[tid] = exhausted
        self.defrag_events[tid] = defrags

    def record_migration(self, src: str, dst: str, *, completed: bool,
                         blocks: int = 0) -> None:
        """One request-migration attempt src -> dst. ``blocks`` is the
        number of KV pages actually shipped (0 on an aborted attempt)."""
        self.migrations_attempted[src] += 1
        if completed:
            self.migrations_completed[src] += 1
            self.migration_blocks[src] += blocks
        else:
            self.migrations_aborted[src] += 1

    def record_migration_stall(self, tid: str, ticks: int) -> None:
        """Mirror an engine's cumulative frozen-slot stall ticks (decode
        iterations a slot sat unservable mid-hand-off)."""
        self.migration_stall_ticks[tid] = ticks

    def record_stage_load(self, tid: str, loads, bubble: float) -> None:
        """Mirror a pipeline gang's per-stage busy shares and measured
        schedule bubble (vs the analytic ``bubble_fraction(M, S)``) so
        width actions are justified by evidence, not geometry."""
        self.stage_loads[tid] = tuple(float(x) for x in loads)
        self.stage_bubble[tid] = float(bubble)

    def harvest(self, tid: str, finished: Iterable) -> None:
        """Pull TTFT/ITL samples from finished requests' token walls.
        Idempotent per request, so it may be called every fleet step over
        the engine's not-yet-drained finished list."""
        seen = self._seen[tid]
        for req in finished:
            key = (req.rid, req.t_submit)
            if key in seen or not req.t_tok:
                continue
            seen.add(key)
            self.completed[tid] += 1
            self._ttft[tid].append(req.t_tok[0] - req.t_submit)
            self._itl[tid].extend(
                b - a for a, b in zip(req.t_tok, req.t_tok[1:]))

    def drained(self, tid: str) -> None:
        """The engine's finished list was emptied — its keys can't recur."""
        self._seen[tid].clear()

    # -- read-time aggregation ---------------------------------------------
    def ttft_ms(self, tid: str, q: float = 0.95) -> float:
        return percentile(self._ttft[tid], q) * 1e3

    def itl_ms(self, tid: str, q: float = 0.95) -> float:
        return percentile(self._itl[tid], q) * 1e3

    def take_rejected_recent(self) -> int:
        """Fleet-wide rejections since the last call (one autoscaler
        snapshot reads and resets it)."""
        n, self._rejected_since_snapshot = self._rejected_since_snapshot, 0
        return n

    def load_p95(self, tid: str) -> float:
        return percentile([s[0] for s in self._load[tid]], 0.95)

    def replicate(self, now: float) -> dict:
        """Stamped copy of the aggregated view for cross-host replication:
        the federation coordinator keeps the newest replica it could pull
        per host, and judges freshness by ``stamp`` age on ITS clock (so
        host and coordinator clocks never need to agree). Everything in
        the replica is already aggregated — replication cost is O(engines),
        never O(requests)."""
        return {"stamp": float(now),
                "rejected_recent": self._rejected_since_snapshot,
                "engines": self.describe()}

    def describe(self) -> dict:
        return {tid: {"submitted": self.submitted[tid],
                      "completed": self.completed[tid],
                      "rejected": self.rejected[tid],
                      "cache_exhausted": self.cache_exhausted[tid],
                      "defrag_events": self.defrag_events[tid],
                      "migrations_attempted": self.migrations_attempted[tid],
                      "migrations_completed": self.migrations_completed[tid],
                      "migrations_aborted": self.migrations_aborted[tid],
                      "migration_blocks": self.migration_blocks[tid],
                      "migration_stall_ticks":
                          self.migration_stall_ticks[tid],
                      "load_p95": self.load_p95(tid),
                      "ttft_p95_ms": round(self.ttft_ms(tid), 3),
                      "itl_p95_ms": round(self.itl_ms(tid), 3),
                      "stage_loads": list(self.stage_loads.get(tid, ())),
                      "bubble_frac": round(
                          self.stage_bubble.get(tid, 0.0), 4)}
                for tid in sorted(set(self.submitted)
                                  | set(self.completed)
                                  | set(self.rejected)
                                  | set(self.cache_exhausted)
                                  | set(self.migrations_attempted)
                                  | set(self.stage_bubble))}
