"""MetricsBus — per-engine serve-plane telemetry (mirrors
``repro.serve.telemetry``).

The hot path (``ServeFleet.submit`` / ``step``) only ever appends to
bounded deques and bumps counters; all aggregation (sorting for
percentiles) is deferred to read time. Latencies are harvested from the
per-token wall timestamps the engine already records on each ``Request``
(``t_submit`` / ``t_tok``), so serving pays nothing extra for them.

The JAX bus also carries request-migration and pipeline-stage counters
and a replica for the federation; those come with their slices (ROADMAP
Queue 1 items 5, 8 and 9), as does the autoscaler that reads the bus.
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
        # requests already harvested, keyed (rid, t_submit); pruned when
        # the owner engine's finished list is drained
        self._seen: dict[str, set] = collections.defaultdict(set)

    # -- hot path (O(1) appends) -------------------------------------------
    def record_submit(self, tid: str) -> None:
        self.submitted[tid] += 1

    def record_reject(self, tid: str) -> None:
        self.rejected[tid] += 1

    def record_load(self, tid: str, load: int, queued: int) -> None:
        self._load[tid].append((load, queued))

    def record_cache_pressure(self, tid: str, exhausted: int,
                              defrags: int) -> None:
        """Mirror an engine's cumulative exhaustion/defrag counters: a
        fleet can have short queues yet be thrashing its paged pool."""
        self.cache_exhausted[tid] = exhausted
        self.defrag_events[tid] = defrags

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

    def load_p95(self, tid: str) -> float:
        return percentile([s[0] for s in self._load[tid]], 0.95)

    def describe(self) -> dict:
        return {tid: {"submitted": self.submitted[tid],
                      "completed": self.completed[tid],
                      "rejected": self.rejected[tid],
                      "cache_exhausted": self.cache_exhausted[tid],
                      "defrag_events": self.defrag_events[tid],
                      "load_p95": self.load_p95(tid),
                      "ttft_p95_ms": round(self.ttft_ms(tid), 3),
                      "itl_p95_ms": round(self.itl_ms(tid), 3)}
                for tid in sorted(set(self.submitted)
                                  | set(self.completed)
                                  | set(self.rejected)
                                  | set(self.cache_exhausted))}
