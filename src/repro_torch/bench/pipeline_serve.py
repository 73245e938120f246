"""Pipeline serving on the port: elastic K-VF pipeline engines —
token identity at every registered width, measured schedule bubble vs
the GPipe analytic, modeled tokens/s scaling with K, and the live-reshape
stall (mirrors ``benchmarks/pipeline_serve.py``: the same protocol, rows,
gates and CLI, plus ``--device``).

The claims under test:

  1. identity across K — ``PipelineServeEngine`` at every K in the
     template registry emits EXACTLY the single-stage paged engine's
     token streams (the full-layout page pools make the stage split a
     re-layout, invariant I10);
  2. measured bubble tracks the analytic — the per-(stage, microbatch)
     walls fed through ``schedule_stats`` give a measured bubble within
     ``BUBBLE_SLACK`` of ``bubble_fraction(M, K)``. On one card the
     stages run one after another: the measured bubble is the GPipe
     recurrence over measured walls, not idle time on the card;
  3. tokens/s scales with K — MODELED for the full deepseek-67b layer
     stack (95 periods): with a balanced template and concurrent stages,
     ``(P / max_periods_per_stage) * M / (M+K-1)`` over one VF, strictly
     increasing in K (host arithmetic, equal to the JAX driver's);
  4. bounded reshape stall — a live ``apply_reshape`` is a template
     re-selection over the SAME page pools: its wall must be at most
     ``RESHAPE_STALL_RATIO`` of a cold engine construction at the target
     width, and the run it interrupts stays token-identical.

Protocol: one oracle run (single-stage paged ``ServeEngine``) over a
fixed request set, one ``PipelineServeEngine`` run per K on the SAME
requests, then a live-reshape run that narrows K mid-decode. The model
is deepseek-67b's smoke config deepened to 4 layers (every K in 1..4 has
a template), random weights from ``--seed``. Gates 1 and 3 and the
reshape's identity are deterministic; 2 and 4 read wall clocks.

    python -m repro_torch.bench.pipeline_serve --device cpu
    python -m repro_torch.bench.pipeline_serve            # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import make_run_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.runtime.pipeline import bubble_fraction
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.pipeline_engine import PipelineServeEngine
from repro_torch.serve.stages import build_templates

BUBBLE_SLACK = 0.40          # measured vs analytic bubble
RESHAPE_STALL_RATIO = 0.5    # live reshape vs cold re-instantiation


def make_requests(vocab, n, max_new):
    prompts = [np.arange(6) % vocab, (np.arange(8) * 3) % vocab,
               (np.arange(5) + 11) % vocab, (np.arange(7) * 7 + 2) % vocab]
    return [Request(rid=i, prompt=np.asarray(prompts[i % 4], np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def drive(eng, reqs, hook=None, max_steps=400):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not all(r.done for r in reqs):
        if hook:
            hook(steps)
        eng.step()
        steps += 1
        if steps > max_steps:
            raise RuntimeError("run did not converge")
    return [list(r.out) for r in reqs]


def modeled_scaling(num_periods, widths, microbatches):
    """Full-config modeled tokens/s ratio over one VF per width: balanced
    template, concurrent stages, per-period wall uniform."""
    tpls = build_templates(num_periods, max(widths))
    rows = {}
    for k in widths:
        tpl = tpls[k]
        longest = max(hi - lo for lo, hi in
                      (tpl.stage_range(i) for i in range(k)))
        rows[k] = round((num_periods / longest)
                        * microbatches / (microbatches + k - 1), 3)
    return rows


def bench_run():
    """deepseek-67b's smoke config with 4 layers (4 periods)."""
    run = make_run_config("deepseek-67b", "decode_32k", smoke=True)
    return run.replace(model=dataclasses.replace(run.model, num_layers=4))


def bench(n_reqs=3, max_new=6, microbatches=2, widths=(2, 3, 4), seed=0,
          device="cuda", log=print):
    dev = resolve_device(device)
    run = bench_run()
    params = build_model(run).init(seed=seed, device=dev)
    vocab = run.model.vocab_size
    full_periods = make_run_config("deepseek-67b", "decode_32k",
                                   smoke=False).model.num_layers
    eng_kw = dict(device=dev, slots=4, max_len=96)

    rows = [{"name": "protocol", "model": "deepseek-67b (smoke, 4 layers)",
             "requests": n_reqs, "max_new": max_new,
             "microbatches": microbatches, "widths": list(widths),
             "modeled_periods": full_periods,
             "bubble_slack": BUBBLE_SLACK,
             "reshape_stall_ratio": RESHAPE_STALL_RATIO,
             "device": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu")}]
    log(json.dumps(rows[0]))

    t0 = time.perf_counter()
    oracle = ServeEngine(run, params, paged=True, **eng_kw)
    want = drive(oracle, make_requests(vocab, n_reqs, max_new))
    oracle_row = {"name": "oracle_k1",
                  "tokens": sum(len(o) for o in want),
                  "wall_s": round(time.perf_counter() - t0, 3)}
    rows.append(oracle_row)
    log(json.dumps(oracle_row))

    per_k = {}
    for k in widths:
        t0 = time.perf_counter()
        eng = PipelineServeEngine(run, params, stages=k,
                                  microbatches=microbatches, **eng_kw)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = drive(eng, make_requests(vocab, n_reqs, max_new))
        analytic = bubble_fraction(microbatches, k)
        row = {"name": f"pipeline_k{k}", "stages": k,
               "token_identical": got == want,
               "sched_ticks": eng.sched_ticks,
               "measured_bubble": round(eng.measured_bubble, 3),
               "analytic_bubble": round(analytic, 3),
               "bubble_within_slack":
                   eng.measured_bubble <= analytic + BUBBLE_SLACK,
               "stage_loads": [round(x, 3) for x in eng.stage_loads()],
               "build_s": round(build_s, 3),
               "wall_s": round(time.perf_counter() - t0, 3)}
        per_k[k] = row
        rows.append(row)
        log(json.dumps(row))

    # live reshape: narrow the widest engine mid-decode, then time a cold
    # construction at the target width for the stall comparison
    k_hi, k_lo = max(widths), max(widths) - 1
    eng = PipelineServeEngine(run, params, stages=k_hi,
                              microbatches=microbatches, **eng_kw)
    stall = {}

    def narrow(step):
        if step == 1:          # early: every trace length reaches it
            t0 = time.perf_counter()
            eng.apply_reshape(k_lo)
            stall["reshape_wall_s"] = time.perf_counter() - t0

    got = drive(eng, make_requests(vocab, n_reqs, max_new), hook=narrow)
    t0 = time.perf_counter()
    PipelineServeEngine(run, params, stages=k_lo,
                        microbatches=microbatches, **eng_kw)
    cold_s = time.perf_counter() - t0
    reshape_row = {
        "name": "live_reshape", "from_k": k_hi, "to_k": k_lo,
        "token_identical": got == want,
        "reshape_count": eng.reshape_count,
        "reshape_wall_s": round(stall["reshape_wall_s"], 6),
        "cold_restart_s": round(cold_s, 3),
        "stall_ratio": round(stall["reshape_wall_s"] / cold_s, 6)}
    rows.append(reshape_row)
    log(json.dumps(reshape_row))

    modeled = modeled_scaling(full_periods, (1,) + tuple(widths),
                              max(microbatches, 4))
    model_row = {"name": "modeled_full_config",
                 "periods": full_periods,
                 "microbatches": max(microbatches, 4),
                 "tokens_per_s_ratio": {str(k): v
                                        for k, v in modeled.items()}}
    rows.append(model_row)
    log(json.dumps(model_row))

    ratios = [modeled[k] for k in sorted(modeled)]
    summary = {
        "name": "summary",
        "token_identical_all_k": all(per_k[k]["token_identical"]
                                     for k in widths),
        "bubble_within_slack_all_k": all(per_k[k]["bubble_within_slack"]
                                         for k in widths),
        "modeled_scaling_monotonic": all(a < b for a, b in
                                         zip(ratios, ratios[1:])),
        "reshape_token_identical": reshape_row["token_identical"],
        "reshape_stall_ratio": reshape_row["stall_ratio"],
        "reshape_stall_bounded":
            reshape_row["stall_ratio"] <= RESHAPE_STALL_RATIO}
    summary["all_gates"] = (
        summary["token_identical_all_k"]
        and summary["bubble_within_slack_all_k"]
        and summary["modeled_scaling_monotonic"]
        and summary["reshape_token_identical"]
        and summary["reshape_stall_bounded"])
    rows.append(summary)
    log(json.dumps(summary))
    return rows


def identities_hold(summary: dict) -> bool:
    """The deterministic gates: token identity at every K and across the
    live reshape, and the modeled scaling."""
    return (summary["token_identical_all_k"]
            and summary["reshape_token_identical"]
            and summary["modeled_scaling_monotonic"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reqs", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--widths", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = bench(n_reqs=args.reqs, max_new=args.max_new,
                 microbatches=args.microbatches,
                 widths=tuple(args.widths), seed=args.seed,
                 device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if rows[-1]["all_gates"] else 1


if __name__ == "__main__":
    sys.exit(main())
