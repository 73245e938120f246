"""Serving driver: batched requests through the continuous-batching engine,
bare or as a fleet of engine tenants under the SVFF manager (mirrors
``repro.launch.serve``: the same flags and the same JSON line).

Serves synthetic requests and reports latency/throughput. Runs on the
card unless ``--device cpu`` is given. The KV cache is the dense per-slot
ring unless ``--paged`` asks for block-granular pages. ``--prefill-chunk
C`` prefills prompts longer than C tokens C at a time (all-attention
stacks). ``--fleet N`` serves through a ``ServeFleet``; adding
``--autoscale`` turns on the elastic control plane — one
``autoscale_step`` per drive-loop tick plans and executes scale-out /
scale-in / rebalance from live telemetry, with ``--spares`` warm parked
standby engines for pause-free scale-out.

    python -m repro_torch.launch.serve --paged
    python -m repro_torch.launch.serve --fleet 2 --slo-max-load 4
    python -m repro_torch.launch.serve --fleet 1 --autoscale --spares 2 \
        --slo-max-load 4 --requests 16
    python -m repro_torch.launch.serve --arch jamba-1.5-large-398b-1p-dense
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --paged
    python -m repro_torch.launch.serve --arch internvl2-1b --max-len 320

``--arch`` takes every registered architecture. The synthetic prompts
are 4-11 tokens, inside every layer's sequence rule (the SSM and mLSTM
chunk rules, the MoE group rule). A vision model's prompt follows its
patch rows, so ``--max-len`` must cover them (internvl2-1b: 256 at full
width, 8 at smoke size).
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import SHAPES, list_archs, make_run_config
from repro_torch.core.autoscaler import AutoscaleConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.fleet import ServeFleet
from repro_torch.serve.paged import RequestRejected


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_archs())
    ap.add_argument("--shape", default="decode_32k", choices=list(SHAPES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="block-granular paged KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill (attention stacks; 0 = whole)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve through a ServeFleet of N engine tenants"
                         " under the SVFFManager (0 = bare engine)")
    ap.add_argument("--autoscale", action="store_true",
                    help="fleet mode: enable the elastic control plane")
    ap.add_argument("--spares", type=int, default=1,
                    help="fleet mode: warm parked standby engines")
    ap.add_argument("--slo-max-load", type=int, default=None,
                    help="fleet mode: per-engine admission bound "
                         "(default 64)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)

    if args.slo_max_load is not None and args.fleet <= 0:
        raise NotImplementedError(
            "--slo-max-load: the admission bound exists in fleet mode only "
            "(give --fleet N)")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 logits in fp32
    run = make_run_config(args.arch, args.shape, smoke=args.smoke)
    model = build_model(run)
    params = model.init(seed=run.seed, device=device)
    reqs = _requests(run, args)
    if args.fleet > 0:
        return _serve_fleet(run, params, reqs, args, device)
    eng = ServeEngine(run, params, device=device, slots=args.slots,
                      max_len=args.max_len, paged=args.paged,
                      page_size=args.page_size,
                      prefill_chunk=args.prefill_chunk)
    for r in reqs:
        eng.submit(r)

    t0 = time.perf_counter()
    steps = 0
    while (eng.step() or eng.queue or eng._jobs) and steps < 10_000:
        steps += 1
    wall = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    out = {"requests": len(reqs), "completed": sum(r.done for r in reqs),
           "decode_steps": steps, "generated_tokens": toks,
           "wall_s": wall, "tokens_per_s": toks / wall}
    print(json.dumps(out))
    return 0 if out["completed"] == len(reqs) else 1


def _requests(run, args) -> list:
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, run.model.vocab_size, plen),
            max_new_tokens=args.new_tokens,
            temperature=args.temperature, top_k=args.top_k))
    return reqs


def _serve_fleet(run, params, reqs, args, device) -> int:
    autoscale = None
    if args.autoscale:
        autoscale = AutoscaleConfig(
            hysteresis=1, cooldown=2,
            max_engines=args.fleet + args.spares, pinned=("serve0",))
    workdir = tempfile.mkdtemp(prefix="svff_serve_")
    try:
        fleet = ServeFleet(
            run, params, num_engines=args.fleet, device=device,
            num_devices=max(2 * (args.fleet + args.spares), 4),
            num_vfs=args.fleet + (args.spares if args.autoscale else 0),
            slots=args.slots, max_len=args.max_len, paged=args.paged,
            page_size=args.page_size, prefill_chunk=args.prefill_chunk,
            slo_max_load=(64 if args.slo_max_load is None
                          else args.slo_max_load), autoscale=autoscale,
            spare_engines=args.spares if args.autoscale else 0,
            workdir=workdir)
        t0 = time.perf_counter()
        pending = list(reqs)
        steps = 0
        actions = []
        while (pending or any(tn.load for tn in fleet.tenants.values())) \
                and steps < 10_000:
            retry = []
            for r in pending:
                try:
                    fleet.submit(r)
                except RequestRejected:
                    retry.append(r)     # side-effect-free: resubmit later
            pending = retry
            if autoscale is not None:
                act = fleet.autoscale_step()
                if act is not None:
                    actions.append({"step": steps, "kind": act.kind,
                                    "reason": act.reason})
            fleet.step()
            steps += 1
        res = fleet.drain()
        wall = time.perf_counter() - t0
        journal_pending = fleet.mgr.query()["journal_pending"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    toks = sum(len(r.out) for r in reqs)
    out = {"mode": "fleet", "engines_initial": args.fleet,
           "engines_final": sum(1 for tn in fleet.tenants.values()
                                if tn.status == "running"),
           "requests": len(reqs), "completed": sum(r.done for r in reqs),
           "drained": res.drained, "fleet_steps": steps,
           "generated_tokens": toks, "wall_s": wall,
           "tokens_per_s": toks / wall,
           "rejected_submissions": fleet.rejected_total,
           "autoscale_actions": actions,
           "journal_pending": journal_pending}
    print(json.dumps(out))
    return 0 if out["completed"] == len(reqs) else 1


if __name__ == "__main__":
    sys.exit(main())
