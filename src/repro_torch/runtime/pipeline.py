"""The GPipe schedule of the host-side serving pipeline (mirrors the host
arithmetic of ``repro.runtime.pipeline``).

M microbatches flow through S stages in M + S - 1 ticks; work item
(stage s, microbatch m) runs at tick s + m. ``serve_schedule`` gives the
items in tick order, ``bubble_fraction`` the analytic idle share
(S-1)/(M+S-1), and ``schedule_stats`` folds measured per-item walls
through the GPipe finish-time recurrence into a makespan and a measured
bubble. All of it is host arithmetic, equal to the JAX package's.

``pipeline_apply`` is the JAX package's mesh GPipe (stages on a "pipe"
mesh axis, activations rotated with ``ppermute``) over a
``torch.distributed`` group: rank r is stage r, and the activations move
one hop a tick by point-to-point sends. The group's backend decides the
transport: under gloo a card's activations go through pinned host memory
for the sends (gloo refuses the card's tensors there), and the final
broadcast takes them as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import flatten, unflatten


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


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _staged(group, t) -> bool:
    """Whether ``t`` goes through host memory to a point-to-point op: gloo
    takes the card's tensors for its collectives but not for send and
    recv (``tools/gloo_cuda_probe.py``: torch 2.11 on an H100)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _hop(group, rank: int, y, recv_like, send: bool, recv: bool):
    """One tick's rotation on ``rank``: send ``y`` to the next stage and
    receive the previous stage's activation (shaped like ``recv_like``),
    as one ``batch_isend_irecv``. A card's tensors go through pinned host
    memory where the group is gloo."""
    host = _staged(group, recv_like)
    ops, box = [], None
    if send:
        out = y.contiguous()
        if host:
            out = torch.empty(out.shape, dtype=out.dtype,
                              pin_memory=True).copy_(out)
        ops.append(dist.P2POp(dist.isend, out, _global(group, rank + 1),
                              group))
    if recv:
        box = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                          device="cpu" if host else recv_like.device,
                          pin_memory=host)
        ops.append(dist.P2POp(dist.irecv, box, _global(group, rank - 1),
                              group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return None if box is None else box.to(recv_like.device)


def pipeline_apply(stage_fn: Callable, stage_params, x, group=None):
    """Run ``y = stage_{S-1}(...stage_0(x))`` as a GPipe pipeline over the
    group's S ranks, rank r being stage r.

    stage_fn: (params of one stage, (mb, ...)) -> (mb, ...), same shape
    stage_params: a tree whose leaves have a leading dim S (one slice per
              stage); rank r uses ``[r]``
    x: (M, mb, ...) microbatches (the same on every rank; stage 0 reads
       it)
    Returns the (M, mb, ...) outputs on every rank.

    The JAX tick loop: M + S - 1 ticks; at tick t stage s holds microbatch
    t - s, stage 0 takes ``x[t]``, the last stage's output at tick t is
    microbatch t - (S - 1), and the activations move one hop between
    ticks. A stage computes only the ticks where it holds a microbatch
    (JAX's idle stages compute values it throws away), and a hop is sent
    only where the next stage will use it, so a tick's sends and receives
    pair up and no rank waits on one that is never posted. The last
    stage's outputs reach every rank by a broadcast, which keeps their
    bits."""
    if not dist.is_initialized():
        raise RuntimeError("pipeline_apply needs an initialised "
                           "torch.distributed process group")
    S = dist.get_world_size(group)
    r = dist.get_rank(group)
    flat, treedef = flatten(stage_params)
    for path, leaf in flat:
        if tuple(leaf.shape[:1]) != (S,):
            raise ValueError(f"stage_params{path} has shape "
                             f"{tuple(leaf.shape)}: its leading dim must be "
                             f"the group's {S} stages")
    params = unflatten(treedef, [leaf[r] for _, leaf in flat])
    M = x.shape[0]
    last = S - 1
    outs = torch.empty_like(x, memory_format=torch.contiguous_format)
    state = None
    for t in range(M + S - 1):
        m = t - r                      # the microbatch this stage holds
        y = None
        if 0 <= m < M:
            y = stage_fn(params, x[m] if r == 0 else state)
            if r == last:
                outs[m] = y
        send = r < last and y is not None
        recv = r > 0 and 0 <= t + 1 - r < M
        if send or recv:
            state = _hop(group, r, y, x[0], send, recv)
    if S > 1:
        dist.broadcast(outs, _global(group, last), group=group)
    return outs
