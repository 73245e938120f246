"""The serve-plane hot path under fleet-level concurrency, on the port
(mirrors ``benchmarks/serve_path.py``: the same nine rows, protocol and
report keys).

Rows:

  dense_ring_16        the dense per-slot KV ring of ``max_len`` rows;
                       decode walks the whole ``slots x max_len``
                       allocation every step (through the plain attention
                       with per-slot KV lengths, as in JAX)
  paged_16             block-granular paged KV: the pool is sized to the
                       tokens in flight, decode is block-table-indirected
                       and bucketed to the pages written so far
  paged_16_chunked     + chunked prefill (admission interleaves with the
                       running batch's decode)
  paged_32             the same paged engine at 32-way concurrency with
                       HOST sampling — throughput reference and the I10
                       bit-identity oracle for the fused rows
  paged_fused_32       + temperature/top-k Gumbel sampling on the device
                       (``fused_sample``): token streams must be
                       bit-identical to paged_32
  paged_fused_int8_32  + int8-quantized paged KV (kv_dtype='int8'),
                       bit-identical to a host-sampled int8 twin
  paged_fleet_steady   one paged engine as a tenant under the SVFF
                       manager, no reconfiguration (the p95 baseline)
  paged_live_pause     the same fleet serving THROUGH a mid-run
                       ``pause_live`` + unpause

Latency metrics per row: tokens/s, TTFT p50/p95 (submit -> first token),
inter-token latency p50/p95 (consecutive token walls within one request).

Gates of the JAX benchmark: paged_speedup_vs_dense >= 1.5,
live_pause_itl_p95_ratio <= 3.0, fused_int8_speedup_vs_baseline >= 1.5,
and both bit identities. ``PAGED16_BASELINE`` is a tokens/s figure of the
JAX package on a CPU backend (its committed ``BENCH_serve_path.json``),
kept for the report's keys: on the card the speedup against it compares
an H100 rate with a CPU rate, so the port reports it and never holds it;
``fused_int8_speedup_vs_paged16`` is the within-run ratio. The two bit
identities hold on any device (``identities_hold``). ``main`` exits 1
when an identity or one of the two within-run wall-clock gates misses.

    python -m repro_torch.bench.serve_path --device cpu --smoke
    python -m repro_torch.bench.serve_path           # full width, card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import make_run_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.runtime.roofline import kernel_roofline, measure_local_peaks
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.fleet import ServeFleet
from repro_torch.serve.paged import init_paged_cache
from repro_torch.tree import tree_items, tree_leaves

# paged_16 tokens/s of the JAX package on a CPU backend (its committed
# BENCH_serve_path.json): the JAX benchmark's pinned denominator for the
# fused+int8 gate, kept for the report's keys
PAGED16_BASELINE = 1522.35


def pct(xs, q):
    """Ceil-based nearest rank, matching serve/telemetry.percentile."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))
    return xs[i]


def make_requests(n, vocab, seed=0, max_new=24, sampled=False):
    """With ``sampled``, odd rids draw temperature/top-k Gumbel samples
    (exercising the full sampler, fused or host) and even rids stay
    greedy — the mix every 32-way row uses so fused-vs-host bit-identity
    covers both paths."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(6, 14))),
                    max_new_tokens=max_new,
                    temperature=0.8 if sampled and i % 2 else 0.0,
                    top_k=40 if sampled and i % 2 else 0,
                    seed=1000 + i)
            for i in range(n)]


def latencies(reqs):
    ttft, itl = [], []
    for r in reqs:
        if r.t_tok:
            ttft.append(r.t_tok[0] - r.t_submit)
            itl.extend(b - a for a, b in zip(r.t_tok, r.t_tok[1:]))
    return ttft, itl


def warm_requests(vocab):
    """One request per prompt length in the workload's range plus one
    long-decode request that crosses a page boundary, so the timed run
    meets no first-time work (the JAX benchmark's compiles; here the
    caches and kernel builds a first call makes)."""
    rng = np.random.default_rng(999)
    reqs = [Request(rid=10_000 + L, prompt=rng.integers(0, vocab, L),
                    max_new_tokens=4) for L in range(6, 14)]
    reqs.append(Request(rid=10_100, prompt=rng.integers(0, vocab, 13),
                        max_new_tokens=52))
    return reqs


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_engine(run, params, reqs, *, device, **kw):
    eng = ServeEngine(run, params, device=device, **kw)
    for r in warm_requests(run.model.vocab_size):
        eng.submit(r)
    eng.run_until_idle()
    _sync(device)
    t0 = time.perf_counter()
    for r in reqs:
        r.t_submit = time.perf_counter()
        eng.queue.append(r)
    res = eng.run_until_idle()
    wall = time.perf_counter() - t0
    assert res.drained and all(r.done for r in reqs)
    return wall


def run_fleet(run, params, reqs, *, slots, max_len, page_size,
              pause: bool, device, pause_after_frac=0.3):
    """One paged engine as a tenant under the real manager; with ``pause``
    a pause_live (pre-copy rounds serve traffic) + unpause fires mid-run.
    The no-pause variant is the steady-state baseline for the p95
    inter-token comparison (same fleet loop, same overheads)."""
    with tempfile.TemporaryDirectory(prefix="svff_bench_") as wd:
        fleet = ServeFleet(run, params, num_engines=1, num_devices=2,
                           slots=slots, max_len=max_len, paged=True,
                           page_size=page_size, workdir=wd, device=device)
        tn = fleet.tenants["serve0"]
        for r in warm_requests(run.model.vocab_size):
            fleet.submit(r)
        fleet.drain()
        total = sum(r.max_new_tokens for r in reqs)
        fired = not pause
        _sync(device)
        t0 = time.perf_counter()
        for r in reqs:
            r.t_submit = time.perf_counter()
            tn.engine.queue.append(r)
        pause_s = 0.0
        while any(not r.done for r in reqs):
            fleet.step()
            if not fired and sum(len(r.out) for r in reqs) \
                    >= pause_after_frac * total:
                fired = True
                tp = fleet.pause_live("serve0", rounds=2)
                fleet.unpause("serve0")
                pause_s = tp.stop_s
        wall = time.perf_counter() - t0
    assert fired, "pause_live never fired"
    return wall, pause_s


def kv_bytes_per_page(model, run, *, max_len, wide, page_size, kv_dtype,
                      device):
    """Bytes one page holds across the layers (K and V, and the int8
    pool's scales), read off a two-page pool from ``init_paged_cache``."""
    shape = dataclasses.replace(run.shape, seq_len=max_len,
                                global_batch=wide)
    cache = init_paged_cache(model, shape, num_pages=2, page_size=page_size,
                             kv_dtype=kv_dtype, device=device)
    total = 0
    for path, leaf in tree_items(cache):
        if path[-1] in ("k", "v", "xk", "xv", "k_scale", "v_scale",
                        "xk_scale", "xv_scale"):
            total += leaf.numel() * leaf.element_size() // 2  # 2 pages
    return total


def bench(requests=32, slots=16, max_len=1024, page_size=32, max_new=24,
          repeats=1, *, smoke=True, device="cuda", seed=0, run=None,
          params=None, log=print):
    """The nine rows (the last the summary). ``run``/``params`` reuse a
    model already on ``device`` (qwen3-0.6b at decode_32k by default, at
    its smoke widths with ``smoke``; random weights from ``seed``)."""
    dev = resolve_device(device)
    if run is None:
        run = make_run_config("qwen3-0.6b", "decode_32k", smoke=smoke)
    model = build_model(run)
    if params is None:
        params = model.init(seed=seed, device=dev)
    vocab = run.model.vocab_size
    rows = []

    def record(name, wall, reqs, note="", extra=None):
        toks = sum(len(r.out) for r in reqs)
        ttft, itl = latencies(reqs)
        row = {"name": name, "requests": len(reqs),
               "generated_tokens": toks, "wall_s": round(wall, 4),
               "tokens_per_s": round(toks / wall, 2),
               "ttft_p50_ms": round(pct(ttft, 0.5) * 1e3, 3),
               "ttft_p95_ms": round(pct(ttft, 0.95) * 1e3, 3),
               "itl_p50_ms": round(pct(itl, 0.5) * 1e3, 3),
               "itl_p95_ms": round(pct(itl, 0.95) * 1e3, 3),
               "note": note}
        row.update(extra or {})
        rows.append(row)
        log(json.dumps(row))
        return row

    # pool sized to the in-flight tokens, not the worst case
    pages_per_req = math.ceil((14 + max_new) / page_size) + 1
    num_pages = 1 + slots * pages_per_req

    best = {}
    for name, kw in (
            ("dense_ring_16", dict(paged=False)),
            ("paged_16", dict(paged=True, page_size=page_size,
                              num_pages=num_pages)),
            ("paged_16_chunked", dict(paged=True, page_size=page_size,
                                      num_pages=num_pages,
                                      prefill_chunk=8))):
        walls = []
        for rep in range(repeats):
            reqs = make_requests(requests, vocab, seed=rep,
                                 max_new=max_new)
            wall = run_engine(run, params, reqs, device=dev, slots=slots,
                              max_len=max_len, **kw)
            walls.append((wall, reqs))
        wall, reqs = min(walls, key=lambda t: t[0])
        best[name] = record(
            name, wall, reqs,
            note=(f"slots={slots} max_len={max_len} " +
                  ("page={} pool={}p".format(page_size, num_pages)
                   if kw.get("paged") else "dense ring")))

    # the full engine (paged KV + chunked-prefill admission) against the
    # dense ring; the paged_16 row isolates the cache-layout half
    speedup = (best["paged_16_chunked"]["tokens_per_s"]
               / best["dense_ring_16"]["tokens_per_s"])
    layout_speedup = (best["paged_16"]["tokens_per_s"]
                      / best["dense_ring_16"]["tokens_per_s"])
    itl_speedup = (best["dense_ring_16"]["itl_p50_ms"]
                   / max(best["paged_16"]["itl_p50_ms"], 1e-9))

    # -- 32-way rows: fused device sampling + int8 paged KV at doubled
    # concurrency. The host-sampled paged_32 row is the throughput
    # reference at this width and the bit-identity oracle (I10) for the
    # fused row; the fused int8 row's oracle is a host-sampled int8 twin.
    # Each row carries a first-order roofline: analytic decode FLOPs and
    # bytes against the device's measured copy and matmul rates.
    peaks = measure_local_peaks(device=dev)
    wide = 2 * slots
    wide_pages = 1 + wide * pages_per_req
    n_active = run.model.active_param_count()
    params_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    # mean decode context: mean prompt (uniform 6..13) + half the decode
    mean_ctx = 9.5 + (max_new + 1) / 2
    pages_touched = math.ceil(mean_ctx / page_size)

    wide_rows, streams0 = {}, {}
    for name, kw in (
            ("paged_32", {}),
            ("paged_fused_32", dict(fused_sampling=True)),
            ("paged_fused_int8_32", dict(fused_sampling=True,
                                         kv_dtype="int8"))):
        walls = []
        for rep in range(repeats):
            wreqs = make_requests(2 * requests, vocab, seed=100 + rep,
                                  max_new=max_new, sampled=True)
            w = run_engine(run, params, wreqs, device=dev, slots=wide,
                           max_len=max_len, paged=True, page_size=page_size,
                           num_pages=wide_pages, **kw)
            walls.append((w, wreqs))
            if rep == 0:
                streams0[name] = {r.rid: list(r.out) for r in wreqs}
        w, wreqs = min(walls, key=lambda t: t[0])
        toks = sum(len(r.out) for r in wreqs)
        kvb = kv_bytes_per_page(model, run, max_len=max_len, wide=wide,
                                page_size=page_size,
                                kv_dtype=kw.get("kv_dtype"), device=dev)
        bytes_per_tok = params_bytes / wide + kvb * pages_touched
        rl = kernel_roofline(name, flops=2.0 * n_active * toks,
                             bytes_moved=bytes_per_tok * toks, wall_s=w,
                             peaks=peaks)
        wide_rows[name] = record(
            name, w, wreqs,
            note=(f"slots={wide} pool={wide_pages}p "
                  + ("fused sampling " if kw.get("fused_sampling") else "")
                  + (f"kv={kw['kv_dtype']} " if kw.get("kv_dtype") else "")
                  + "(mixed greedy/top-k requests)"),
            extra={"kv_bytes_per_page": kvb,
                   "achieved_bw_gbps": round(rl["achieved_bw"] / 1e9, 3),
                   "achieved_bw_frac": round(rl["achieved_bw_frac"], 4),
                   "roofline_bound": rl["bound"],
                   "peak_hbm_bw_gbps": round(peaks.hbm_bw / 1e9, 3)})

    oreqs = make_requests(2 * requests, vocab, seed=100, max_new=max_new,
                          sampled=True)
    run_engine(run, params, oreqs, device=dev, slots=wide, max_len=max_len,
               paged=True, page_size=page_size, num_pages=wide_pages,
               kv_dtype="int8")
    fused_identical = streams0["paged_fused_32"] == streams0["paged_32"]
    int8_identical = (streams0["paged_fused_int8_32"]
                      == {r.rid: list(r.out) for r in oreqs})
    # -- pause_live under traffic vs the SAME fleet loop without a pause
    nlive = max(requests, 48)
    sreqs = make_requests(nlive, vocab, seed=11, max_new=max_new)
    swall, _ = run_fleet(run, params, sreqs, slots=slots, max_len=max_len,
                         page_size=page_size, pause=False, device=dev)
    steady = record("paged_fleet_steady", swall, sreqs,
                    note="fleet loop, no reconfiguration (p95 baseline)")
    steady_p95 = steady["itl_p95_ms"]

    reqs = make_requests(nlive, vocab, seed=11, max_new=max_new)
    wall, stop_s = run_fleet(run, params, reqs, slots=slots,
                             max_len=max_len, page_size=page_size,
                             pause=True, device=dev)
    live = record("paged_live_pause", wall, reqs,
                  note="pause_live(rounds=2)+unpause mid-run under "
                       "SVFFManager",
                  extra={"pause_stop_ms": round(stop_s * 1e3, 3),
                         "itl_p95_vs_steady":
                             round((pct(latencies(reqs)[1], 0.95) * 1e3)
                                   / max(steady_p95, 1e-9), 3)})

    summary = {"name": "summary",
               "paged_speedup_vs_dense": round(speedup, 3),
               "paged_layout_only_speedup": round(layout_speedup, 3),
               "paged_itl_p50_speedup": round(itl_speedup, 3),
               "speedup_target": 2.0,
               "live_pause_itl_p95_ratio": live["itl_p95_vs_steady"],
               "live_pause_itl_ratio_target": 2.0,
               "concurrency": slots,
               "wide_concurrency": wide,
               "paged16_baseline_tokens_per_s": PAGED16_BASELINE,
               "fused_int8_speedup_vs_baseline":
                   round(wide_rows["paged_fused_int8_32"]["tokens_per_s"]
                         / PAGED16_BASELINE, 3),
               "fused_int8_speedup_vs_paged16":
                   round(wide_rows["paged_fused_int8_32"]["tokens_per_s"]
                         / best["paged_16"]["tokens_per_s"], 3),
               "fused_speedup_vs_host_32":
                   round(wide_rows["paged_fused_32"]["tokens_per_s"]
                         / wide_rows["paged_32"]["tokens_per_s"], 3),
               "fused_target": 1.5,
               "fused_bit_identical": fused_identical,
               "fused_int8_bit_identical": int8_identical}
    rows.append(summary)
    log(json.dumps(summary))
    return rows


def identities_hold(summary: dict) -> bool:
    """The deterministic gates: fused streams equal host-sampled ones."""
    return (summary["fused_bit_identical"]
            and summary["fused_int8_bit_identical"])


def wall_gates(summary: dict) -> dict:
    """The JAX benchmark's wall-clock gates, each True when it holds
    (``fused_int8_speedup_vs_baseline`` divides by a CPU figure of the
    JAX package: on the card it is reported, not held)."""
    return {"paged_speedup_vs_dense >= 1.5":
            summary["paged_speedup_vs_dense"] >= 1.5,
            "live_pause_itl_p95_ratio <= 3.0":
            summary["live_pause_itl_p95_ratio"] <= 3.0,
            "fused_int8_speedup_vs_baseline >= 1.5":
            summary["fused_int8_speedup_vs_baseline"] >= 1.5}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="qwen3-0.6b's smoke widths and a short trace "
                         "(8 requests, 4 slots, max_len 128, 8 new tokens)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(requests=args.requests, slots=args.slots,
              max_len=args.max_len, page_size=args.page_size,
              max_new=args.max_new)
    if args.smoke:
        kw = dict(requests=8, slots=4, max_len=128, page_size=16,
                  max_new=8)
    rows = bench(repeats=args.repeats, smoke=args.smoke, device=args.device,
                 seed=args.seed, **kw)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    summary = rows[-1]
    held = {k: v for k, v in wall_gates(summary).items()
            if "baseline" not in k}
    return 0 if identities_hold(summary) and all(held.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
