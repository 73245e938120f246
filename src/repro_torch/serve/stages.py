"""Stage templates — the precomputed pipeline partitions that let one
serving engine span K VFs (mirrors ``repro.serve.stages``).

A ``StageTemplate`` is a balanced contiguous partition of the model's
``num_periods`` layer periods into K stages (stage i owns periods
``[bounds[i], bounds[i+1])``). Templates are precomputed for every K up
to the engine's maximum width at construction, so a VF loss or a
scale-pressure decision re-instantiates the engine at K±1 by *selecting*
an existing template — a re-layout of the SAME params and KV pages,
never a recompute — which is why a reshape leaves every token stream
unchanged (invariant I10) and why invariant I14 can demand that every
live engine's stage set matches exactly one registered template.

The per-stage step functions are built from the same primitives as the
monolithic model path (``models.model.run_stack`` over a period-sliced
config, ``Model._embed`` / ``Model._logits`` on the boundary stages), so
stage i computes what the monolithic stack computes over its period
range: the boundary tensor is the ``x`` the monolithic stack holds
between those periods, in the compute dtype.

Stage params are views: ``split_stage_params`` slices the layer stacks
of the tree it is given (the engine hands it its compute-dtype copy),
and a decode stage writes its KV through views of the full page pools,
in place, as ``run_stack`` does for the whole stack.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ATTN, ModelConfig, RunConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import _dt, build_model, run_stack
from repro_torch.runtime.partitioning import constrain
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class StageTemplate:
    """One registered pipeline partition: K stages over ``num_periods``
    layer periods. ``bounds`` has K+1 entries, strictly increasing from 0
    to ``num_periods``."""
    k: int
    num_periods: int
    bounds: tuple

    def __post_init__(self):
        check_partition(self.bounds, self.num_periods)
        if len(self.bounds) != self.k + 1:
            raise ValueError(
                f"template k={self.k}: bounds {self.bounds} has "
                f"{len(self.bounds) - 1} stages")

    def stage_range(self, i: int) -> tuple:
        return (self.bounds[i], self.bounds[i + 1])


def check_partition(bounds, num_periods: int) -> None:
    """I14's partition predicate: ``bounds`` must tile [0, num_periods)
    cleanly — strictly increasing, starting at 0, ending at the period
    count — so stage-resident params/KV neither overlap nor leave gaps."""
    b = tuple(int(x) for x in bounds)
    if len(b) < 2 or b[0] != 0 or b[-1] != num_periods:
        raise ValueError(
            f"stage bounds {b} do not span [0, {num_periods}]")
    for lo, hi in zip(b, b[1:]):
        if hi <= lo:
            raise ValueError(f"stage bounds {b} not strictly increasing")


def build_templates(num_periods: int, max_k: int) -> dict:
    """Balanced contiguous partitions for every width 1..min(max_k, P).
    Stage i of width k owns ceil/floor(P/k) periods (the first P%k stages
    take the extra one), so the widest stage never exceeds the narrowest
    by more than one period."""
    if num_periods < 1:
        raise ValueError(f"num_periods must be >= 1, got {num_periods}")
    if max_k < 1:
        raise ValueError(f"max_k must be >= 1, got {max_k}")
    out = {}
    for k in range(1, min(max_k, num_periods) + 1):
        base, extra = divmod(num_periods, k)
        bounds = [0]
        for i in range(k):
            bounds.append(bounds[-1] + base + (1 if i < extra else 0))
        out[k] = StageTemplate(k=k, num_periods=num_periods,
                               bounds=tuple(bounds))
    return out


def pipeline_supported(cfg: ModelConfig) -> tuple:
    """(ok, why): which model stacks the serve pipeline can span —
    homogeneous attention decoders. Recurrent blocks would need their
    inter-stage state threaded through the host boundary, and frontends
    (vision patches / audio frames) belong to stage 0 only, which the
    balanced templates do not model."""
    if any(b != ATTN for b in cfg.block_pattern):
        return False, f"block pattern {cfg.block_pattern} is not all-attn"
    if cfg.is_encoder_decoder:
        return False, "encoder-decoder stacks are not stage-splittable"
    if cfg.frontend.kind != "none":
        return False, f"frontend {cfg.frontend.kind!r} not supported"
    return True, ""


def split_stage_params(params: dict, cfg: ModelConfig,
                       template: StageTemplate) -> list:
    """Slice the param tree into per-stage trees that mirror the full
    structure, so ``Model._embed`` / ``Model._logits`` / ``run_stack``
    consume them verbatim:

      every stage   {"decoder": {"layers": block leaves sliced [lo:hi]}}
      stage 0       + "embed" (the token table feeds ``_embed``)
      last stage    + "decoder.final_norm", and "lm_head" or "embed"
                    (tied) for ``_logits``

    The leaves are views of ``params``' tensors: a reshape re-slices, it
    never copies or re-initializes."""
    out = []
    layers = params["decoder"]["layers"]
    last = template.k - 1
    for i in range(template.k):
        lo, hi = template.stage_range(i)
        sp = {"decoder": {"layers": tree_map(lambda leaf: leaf[lo:hi],
                                             layers)}}
        if i == 0:
            sp["embed"] = params["embed"]
        if i == last:
            sp["decoder"]["final_norm"] = params["decoder"]["final_norm"]
            if cfg.tie_embeddings:
                sp["embed"] = params["embed"]
            elif "lm_head" in params:
                sp["lm_head"] = params["lm_head"]
        out.append(sp)
    return out


def _stage_cfg(cfg: ModelConfig, lo: int, hi: int) -> ModelConfig:
    """A config whose layer stack is exactly this stage's period range —
    ``run_stack`` reads ``num_layers // len(block_pattern)`` periods."""
    return dataclasses.replace(
        cfg, num_layers=(hi - lo) * len(cfg.block_pattern))


def make_stage_decode(run: RunConfig, lo: int, hi: int, *, first: bool,
                      last: bool):
    """One pipeline stage of the paged continuous-batching decode step.

    first stage:  (params, cache, tokens (B,1) int, pos, tables, active)
    later stages: (params, cache, x (B,1,D) cdt, pos, tables, active)
    The last stage returns (logits (B,V), cache), the others (x, cache) —
    ``Model.decode_step``'s tail exactly. ``cache`` is this stage's
    period range of the pools (views): the step writes its KV there in
    place and returns it. ``pos`` is (B,) per slot (or one 0-d
    position); ``positions``, when given, is the rope positions the
    caller derived from ``pos`` once for every stage."""
    cfg = run.model
    scfg = _stage_cfg(cfg, lo, hi)
    model = build_model(run)           # _embed/_logits (stack-size agnostic)
    cdt = _dt(run.precision.compute)

    def step(params, cache, xin, pos, tables, active, positions=None):
        x = constrain(model._embed(params, xin, cdt), "hidden") if first \
            else xin
        if positions is None:
            positions = (pos.to(torch.int64).clamp(min=0)[:, None]
                         if pos.dim() == 1 else
                         pos.reshape(1).to(torch.int64))
        x, _, cache = run_stack(
            scfg, run, params["decoder"]["layers"], x, "decode",
            cache=cache, positions=positions, pos=pos, tables=tables,
            active=active)
        if not last:
            return x, cache
        x = rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)
        return model._logits(params, x)[:, 0], cache

    return step


def make_stage_prefill(run: RunConfig, lo: int, hi: int, *, first: bool,
                       last: bool):
    """One pipeline stage of the B=1 whole-prompt prefill. Every stage
    returns (y, stage_cache) where ``y`` is the boundary activation —
    except the last stage, whose ``y`` is the last position's logits row
    (``Model.prefill``'s return contract: only that row is computed)."""
    cfg = run.model
    scfg = _stage_cfg(cfg, lo, hi)
    model = build_model(run)
    cdt = _dt(run.precision.compute)

    def step(params, xin):
        x = constrain(model._embed(params, xin, cdt), "hidden") if first \
            else xin
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, cache = run_stack(scfg, run, params["decoder"]["layers"], x,
                                "prefill", positions=positions)
        if not last:
            return x, cache
        x = rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)
        return model._logits(params, x[:, -1:])[:, 0], cache

    return step
