"""The GPipe schedule of the host-side serving pipeline (mirrors the host
arithmetic of ``repro.runtime.pipeline``).

M microbatches flow through S stages in M + S - 1 ticks; work item
(stage s, microbatch m) runs at tick s + m. ``serve_schedule`` gives the
items in tick order, ``bubble_fraction`` the analytic idle share
(S-1)/(M+S-1), and ``schedule_stats`` folds measured per-item walls
through the GPipe finish-time recurrence into a makespan and a measured
bubble. All of it is host arithmetic, equal to the JAX package's.

The mesh GPipe (``pipeline_apply``: the stages on a "pipe" mesh axis,
activations rotated with collective permutes) is not here: in the port
it needs ``torch.distributed`` and comes with the collectives (ROADMAP
Queue 1 item 10).
"""
from __future__ import annotations

import dataclasses


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def serve_schedule(num_microbatches: int, num_stages: int):
    """The GPipe work-item order for the host-side serving pipeline
    (``repro_torch.serve.pipeline_engine``): (stage, microbatch) pairs in
    tick order, tick t = stage + microbatch. Executing items in this order
    satisfies both dependencies of item (s, m) — (s-1, m) ran at tick
    t-1 (activation hand-off) and (s, m-1) ran at tick t-1 (the stage's
    KV cache threads through its own microbatches)."""
    M, S = num_microbatches, num_stages
    for t in range(M + S - 1):
        for s in range(S):
            m = t - s
            if 0 <= m < M:
                yield s, m


@dataclasses.dataclass(frozen=True)
class ScheduleStats:
    """Measured pipeline utilization from per-item wall times.

    ``walls[s][m]`` is the measured wall of work item (stage s,
    microbatch m). The makespan is the GPipe critical path —
    finish(s, m) = max(finish(s-1, m), finish(s, m-1)) + walls[s][m] —
    and the measured bubble fraction is the idle share of the S-stage
    schedule area: 1 - sum(walls) / (S * makespan). With uniform walls
    this reduces exactly to ``bubble_fraction(M, S)``. On one card the
    stages run one after another, so this is the recurrence over the
    measured walls, not idle time the card saw."""
    num_stages: int
    num_microbatches: int
    makespan: float
    busy: float
    stage_busy: tuple

    @property
    def bubble(self) -> float:
        if self.makespan <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.busy /
                   (self.num_stages * self.makespan))


def schedule_stats(walls) -> ScheduleStats:
    """Fold per-item walls (list of S lists of M floats) into
    ``ScheduleStats`` via the GPipe finish-time recurrence."""
    S = len(walls)
    M = len(walls[0]) if S else 0
    finish = [[0.0] * M for _ in range(S)]
    for s, m in serve_schedule(M, S):
        up = finish[s - 1][m] if s > 0 else 0.0
        left = finish[s][m - 1] if m > 0 else 0.0
        finish[s][m] = max(up, left) + walls[s][m]
    makespan = finish[S - 1][M - 1] if S and M else 0.0
    stage_busy = tuple(float(sum(row)) for row in walls)
    return ScheduleStats(num_stages=S, num_microbatches=M,
                         makespan=float(makespan),
                         busy=float(sum(stage_busy)),
                         stage_busy=stage_busy)
