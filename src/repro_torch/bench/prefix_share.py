"""Effective cache capacity under a shared-prefix trace, on the port
(mirrors ``benchmarks/prefix_share.py``: the same trace, rows, report
keys and gates).

The trace models system-prompt traffic: every request opens with the same
96-token system prefix (6 full pages at page_size 16) and closes with a
short per-pair tail — pairs share their tail too, so the trace exercises
full-page sharing, partial-page sharing, AND the copy-on-write splits
that fire when paired requests start decoding into their shared partial
page.

Rows:

  copy_on_admit        every admission copies its full KV into private
                       pages — N residents on one system prompt burn N
                       copies of its pages
  prefix_share         the refcounted trie + CoW path (share_prefix=True):
                       residents map their block tables onto the same
                       physical prefix pages; divergence splits exactly
                       one page per writer

The headline metric is ``peak_pages_at_full_residency``: pool pages in
use while ALL slots are resident, so the ratio is the effective-capacity
multiplier. The gates are deterministic (page accounting and token
identity), so they hold on any device and width:

  capacity_ratio >= 3.0     (>= 3x effective cache capacity)
  outputs bit-identical     (per token, sharing vs copy-on-admit — I10)

    python -m repro_torch.bench.prefix_share --device cpu --smoke
    python -m repro_torch.bench.prefix_share          # full width, card
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import make_run_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine


def make_trace(n, vocab, prefix_len=96, tail_len=4, max_new=8, seed=0):
    """n requests: one shared system prefix + per-PAIR unique tails (pair
    members are identical end-to-end, so their shared partial page must
    CoW-split when they decode)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len)
    reqs = []
    for i in range(n):
        tail = np.asarray([(17 * (i // 2) + 3 + j) % vocab
                           for j in range(tail_len)])
        reqs.append(Request(rid=i,
                            prompt=np.concatenate([prefix, tail]),
                            max_new_tokens=max_new))
    return reqs


def run_trace(run, params, reqs, *, share, slots, page_size, max_len,
              num_pages, device):
    """Serve the trace to completion, sampling pool pages in use at every
    step; returns (wall_s, peak pages while ALL slots were resident,
    engine stats)."""
    eng = ServeEngine(run, params, device=device, slots=slots,
                      max_len=max_len, paged=True, page_size=page_size,
                      num_pages=num_pages, share_prefix=share)
    # one request of the trace's prompt length and decode width first
    warm = Request(rid=9_999, prompt=np.asarray(reqs[0].prompt).copy(),
                   max_new_tokens=reqs[0].max_new_tokens)
    eng.submit(warm)
    eng.run_until_idle()
    t0 = time.perf_counter()
    for r in reqs:
        r.t_submit = time.perf_counter()
        eng.queue.append(r)
    peak_full = 0
    steps = 0
    while (eng.step() or eng.queue) and steps < 10_000:
        resident = sum(r is not None for r in eng.active)
        if resident == slots:
            peak_full = max(peak_full, eng.alloc.pages_in_use)
        steps += 1
    wall = time.perf_counter() - t0
    assert all(r.done for r in reqs)
    assert eng.alloc.pages_in_use == 0
    eng.alloc.check_invariants()
    assert peak_full > 0, "trace never reached full residency"
    return wall, peak_full, dict(eng.stats)


def bench(requests=8, slots=8, prefix_len=96, tail_len=4, max_new=8,
          page_size=16, max_len=128, num_pages=64, *, smoke=True,
          device="cuda", seed=0, run=None, params=None, log=print):
    """The two rows and the summary. ``run``/``params`` reuse a model
    already on ``device`` (qwen3-0.6b at decode_32k by default, at its
    smoke widths with ``smoke``; random weights from ``seed``)."""
    dev = resolve_device(device)
    if run is None:
        run = make_run_config("qwen3-0.6b", "decode_32k", smoke=smoke)
    if params is None:
        params = build_model(run).init(seed=seed, device=dev)
    vocab = run.model.vocab_size
    rows = []
    outs = {}

    for name, share in (("copy_on_admit", False), ("prefix_share", True)):
        reqs = make_trace(requests, vocab, prefix_len=prefix_len,
                          tail_len=tail_len, max_new=max_new)
        wall, peak, stats = run_trace(run, params, reqs, share=share,
                                      slots=slots, page_size=page_size,
                                      max_len=max_len,
                                      num_pages=num_pages, device=dev)
        toks = sum(len(r.out) for r in reqs)
        outs[name] = [list(r.out) for r in reqs]
        row = {"name": name, "requests": len(reqs),
               "resident_slots": slots,
               "generated_tokens": toks,
               "wall_s": round(wall, 4),
               "tokens_per_s": round(toks / wall, 2),
               "peak_pages_at_full_residency": peak,
               "shared_page_hits": stats.get("shared_page_hits", 0),
               "cow_splits": stats.get("cow_splits", 0),
               "note": (f"prefix={prefix_len} tail={tail_len} "
                        f"page={page_size} pool={num_pages}p")}
        rows.append(row)
        log(json.dumps(row))

    base = rows[0]["peak_pages_at_full_residency"]
    shared = rows[1]["peak_pages_at_full_residency"]
    summary = {"name": "summary",
               "capacity_ratio": round(base / shared, 3),
               "capacity_ratio_target": 3.0,
               "outputs_bit_identical":
                   outs["copy_on_admit"] == outs["prefix_share"],
               "cow_splits": rows[1]["cow_splits"],
               "shared_page_hits": rows[1]["shared_page_hits"]}
    rows.append(summary)
    log(json.dumps(summary))
    return rows


def gates_hold(summary: dict) -> bool:
    """Both gates are deterministic (page accounting + token identity),
    so they are the acceptance numbers, not relaxed floors."""
    return (summary["capacity_ratio"] >= summary["capacity_ratio_target"]
            and summary["outputs_bit_identical"]
            and summary["cow_splits"] >= 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prefix-len", type=int, default=96)
    ap.add_argument("--tail-len", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--num-pages", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="qwen3-0.6b's smoke widths (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = bench(requests=args.requests, slots=args.slots,
                 prefix_len=args.prefix_len, tail_len=args.tail_len,
                 max_new=args.max_new, page_size=args.page_size,
                 max_len=args.max_len, num_pages=args.num_pages,
                 smoke=args.smoke, device=args.device, seed=args.seed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if gates_hold(rows[-1]) else 1


if __name__ == "__main__":
    sys.exit(main())
