"""PipelineServeEngine — one serving engine spanning K VFs as pipeline
stages (mirrors ``repro.serve.pipeline_engine``).

The engine IS a paged ``ServeEngine``: admission, sampling (the I10
oracle), page bookkeeping, migration, pause/export — all inherited. What
changes is the two step entry points:

  ``_prefill``   runs the B=1 prompt through the K per-stage prefill
                 functions one after another and stacks their caches on
                 the period axis into the full-layout request cache, so
                 the base class's copy-on-admit path is unchanged
  ``_decode``    a HOST-side GPipe schedule: the active slots split into
                 M round-robin microbatch groups, and work item (stage
                 s, group m) runs at tick s+m
                 (``runtime.pipeline.serve_schedule``)

The page pools keep the FULL layout (every leaf leads with the period
axis), exactly as in the single-stage engine. Stage s reads and writes
``leaf[lo:hi]`` — views of the pools — so its KV writes land in place
and nothing is concatenated back. A reshape K -> K' is a re-layout (new
template bounds, re-sliced params over the SAME bytes), so every
in-flight request decodes on unchanged across it (I10), and the base
class's export/import/migration plumbing, which indexes the pools by
page, needs no pipeline awareness.

A masked group call gives each of its rows what one full-batch call
gives it: decode rows are independent (each slot attends through its
own block table), an inactive row's KV write goes to the reserved page
0, and its attention (pos -1) reads nothing; the call has the full
batch's shapes. The schedule changes WHEN a slot's row is computed,
never what it reads.

Stage params are views of the engine's compute-dtype params
(``_cparams``), made once per width and dropped with the engine's
device state (``drop_device_state``, a params import, a reshape), so a
paused engine's views pin nothing on the card.

Each work item's wall (a ``torch.cuda.synchronize()`` after it on the
card) feeds ``runtime.pipeline.schedule_stats``: ``stage_busy_s``,
``measured_bubble`` (beside the analytic ``bubble_fraction(M, K)``) and
``sched_ticks``. On one card the K stages run one after another, so the
measured bubble is the GPipe recurrence over measured walls, not idle
time the card saw.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.runtime.pipeline import schedule_stats, serve_schedule
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.stages import (StageTemplate, build_templates,
                                      make_stage_decode, make_stage_prefill,
                                      pipeline_supported, split_stage_params)
from repro_torch.tree import tree_map


class PipelineServeEngine(ServeEngine):
    def __init__(self, run, params, *, stages: int = 2,
                 max_stages: Optional[int] = None, microbatches: int = 2,
                 **kw):
        ok, why = pipeline_supported(run.model)
        if not ok:
            raise ValueError(f"pipeline serving for {run.model.name}: "
                             f"{why}")
        if kw.pop("fused_sampling", False):
            raise ValueError("pipeline serving samples on the host "
                             "(the I10 oracle); fused_sampling=False")
        if kw.pop("prefill_chunk", 0):
            raise ValueError("pipeline serving prefills whole prompts; "
                             "prefill_chunk=0")
        kw["paged"] = True
        super().__init__(run, params, **kw)
        cfg = run.model
        self.num_periods = cfg.num_layers // len(cfg.block_pattern)
        want_max = max(stages, max_stages or stages)
        self.templates: dict = build_templates(self.num_periods, want_max)
        if stages not in self.templates:
            raise ValueError(
                f"no stage template for K={stages} "
                f"(registered: {sorted(self.templates)})")
        self.max_stage_width = max(self.templates)
        self.microbatches = max(1, int(microbatches))
        self._k = stages
        # the per-stage step functions of EVERY registered template, made
        # at init — a reshape (VF loss, scale pressure) selects an entry
        self._stage_decode: dict = {}
        self._stage_prefill: dict = {}
        for k, tpl in self.templates.items():
            ends = [dict(first=i == 0, last=i == k - 1) for i in range(k)]
            self._stage_decode[k] = [
                make_stage_decode(run, *tpl.stage_range(i), **ends[i])
                for i in range(k)]
            self._stage_prefill[k] = [
                make_stage_prefill(run, *tpl.stage_range(i), **ends[i])
                for i in range(k)]
        # measured schedule telemetry (cumulative since the last reshape)
        self.stage_busy_s: list = [0.0] * stages
        self._cum_busy = 0.0
        self._cum_makespan = 0.0
        self.measured_bubble = 0.0
        self.sched_ticks = 0
        self.reshape_count = 0
        # the base class's step() / _prefill_full() call these with the
        # arguments of the single-stage paged steps
        self._prefill = self._pipeline_prefill
        self._decode = self._pipeline_decode

    # -- device state: the stage views go with the params they view ----------
    def _set_params(self, params):
        self._sparams = None
        super()._set_params(params)

    def drop_device_state(self):
        self._sparams = None
        super().drop_device_state()

    # -- template / width protocol (manager gang ops + I14) ------------------
    @property
    def stage_width(self) -> int:
        return self._k

    def has_template(self, k: int) -> bool:
        return k in self.templates

    def stage_bounds(self) -> tuple:
        return self.templates[self._k].bounds

    def template(self) -> StageTemplate:
        return self.templates[self._k]

    def apply_reshape(self, k: int) -> None:
        """Re-instantiate at width ``k``: select the registered template,
        drop the stage-param views, reset the per-stage telemetry window.
        The page pools and every request byte are untouched — a reshape
        changes the program layout, not the state. Idempotent at the
        current width."""
        if k == self._k:
            return
        if k not in self.templates:
            raise ValueError(f"no stage template for K={k} "
                             f"(registered: {sorted(self.templates)})")
        self._k = k
        self._sparams = None
        self.stage_busy_s = [0.0] * k
        self._cum_busy = 0.0
        self._cum_makespan = 0.0
        self.measured_bubble = 0.0
        self.reshape_count += 1

    def stage_loads(self) -> tuple:
        """Per-stage busy share of the measured makespan (0..1 each)."""
        if self._cum_makespan <= 0.0:
            return tuple(0.0 for _ in range(self._k))
        return tuple(b / self._cum_makespan for b in self.stage_busy_s)

    def _stage_param_slices(self) -> list:
        if self._sparams is None:
            self._sparams = split_stage_params(
                self._cparams, self.run.model, self.templates[self._k])
        return self._sparams

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the two overridden entry points --------------------------------------
    def _pipeline_prefill(self, params, batch):
        """(params, batch) -> (full-layout request cache, last logits) —
        the contract ``_prefill_full`` expects. ``params`` (the compute
        copy) is read through the stage views."""
        sp = self._stage_param_slices()
        y = batch["tokens"]
        caches = []
        for i, fn in enumerate(self._stage_prefill[self._k]):
            y, c = fn(sp[i], y)
            caches.append(c)
        return tree_map(lambda *ls: torch.cat(ls), *caches), y

    def _pipeline_decode(self, params, cache, tokens, pos, tables, active):
        """(params, cache, tokens, pos, tables, active) -> (logits (B,V),
        cache) — the paged decode contract, run as a host-side GPipe
        schedule over K stages and M round-robin microbatch groups. The
        cache is written in place through each stage's views."""
        sp = self._stage_param_slices()
        fns = self._stage_decode[self._k]
        K = self._k
        tpl = self.templates[K]
        act = active.cpu().numpy()
        pos_h = pos.cpu().numpy()
        idx = np.flatnonzero(act)
        M = max(1, min(len(idx), self.microbatches))
        groups = [idx[m::M] for m in range(M)]
        # each group's mask, positions and rope positions, once a step
        gmasks, gposs, grope = [], [], []
        for g in groups:
            gm = np.zeros(act.shape, bool)
            gm[g] = True
            gp = self._tensor(np.where(gm, pos_h, -1), pos.dtype)
            gmasks.append(self._tensor(gm, torch.bool))
            gposs.append(gp)
            grope.append(gp.to(torch.int64).clamp(min=0)[:, None])
        views = [tree_map(lambda leaf, r=tpl.stage_range(i):
                          leaf[r[0]:r[1]], cache) for i in range(K)]
        xs: list = [tokens] * M          # stage-0 input is the token ids
        last_rows: list = [None] * M
        walls = [[0.0] * M for _ in range(K)]
        for s, m in serve_schedule(M, K):
            t0 = time.perf_counter()
            y, _ = fns[s](sp[s], views[s], xs[m], gposs[m], tables,
                          gmasks[m], positions=grope[m])
            self._sync()
            walls[s][m] = time.perf_counter() - t0
            if s == K - 1:
                last_rows[m] = y
            else:
                xs[m] = y
        out = last_rows[0]
        for m in range(1, M):
            out = torch.where(gmasks[m][:, None], last_rows[m], out)
        st = schedule_stats(walls)
        for i in range(K):
            self.stage_busy_s[i] += st.stage_busy[i]
        self._cum_busy += st.busy
        self._cum_makespan += st.makespan
        if self._cum_makespan > 0.0:
            self.measured_bubble = max(
                0.0, 1.0 - self._cum_busy / (K * self._cum_makespan))
        self.sched_ticks += M + K - 1
        return out, cache
