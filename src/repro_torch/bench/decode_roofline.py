"""Achieved-vs-peak bandwidth for every decode kernel, on the port
(mirrors ``benchmarks/decode_roofline.py``: the same five rows, summary
keys and gates).

Each row is ONE kernel of the serve plane's decode step, timed alone at a
serving-ish shape and reported through ``runtime.roofline.
kernel_roofline``: analytic FLOPs and bytes for the call, its time, and
the achieved fractions against the peaks the run was told to use.

  flash_decode     a dense (B, T, K, hd) cache at one position
  paged_fp         the block-table-indirected page pool
  paged_int8       the same pool int8-quantized with per-(row,head) fp32
                   scales — the analytic bytes drop ~2x (gated <= 0.6x)
  fused_sample     temperature/top-k Gumbel sampling over (B, V) logits
  ssm_scan         the chunked SSD recurrent-path scan

Every row runs at the JAX rows' dtypes: q, the dense cache and the page
pool fp32, the int8 pool with fp32 scales under fp32 q, the sampler's
logits and the scan's inputs fp32; each row records the dtype of its
cache or inputs (``dtype``). A caller may pass its own timer
(``time_fn``: a callable's seconds); the default is the best of ``reps``
calls, synchronized on the card.

Peaks are injectable (``Peaks``): by default the run MEASURES the
device's copy bandwidth and matmul FLOP rate (``measure_local_peaks``),
as the JAX benchmark does; ``Peaks()`` is the H100's data sheet.

Gates:
  * all five rows present with wall_s > 0
  * paged_int8 analytic bytes <= 0.6x paged_fp analytic bytes
  * paged_int8 wall <= 2.5x paged_fp wall

    python -m repro_torch.bench.decode_roofline --device cpu --smoke
    python -m repro_torch.bench.decode_roofline          # the card
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import kv_quant_ref
from repro_torch.runtime.roofline import (Peaks, kernel_roofline,
                                          measure_local_peaks)

ROWS = ("flash_decode", "paged_fp", "paged_int8", "fused_sample",
        "ssm_scan")


def timed_best(fn, reps=5):
    """The fastest of ``reps`` calls after a warm one, in seconds; on the
    card each call is waited for before its clock stops."""
    def call():
        out = fn()
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.synchronize(out.device)
    call()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


def shapes(reduced: bool) -> dict:
    """The JAX benchmark's serving-ish decode shapes (reduced: the same
    rows, smaller walls)."""
    B, H, K, hd = (8, 8, 4, 64) if reduced else (32, 8, 4, 64)
    page, NP = 32, (4 if reduced else 16)   # NP*page logical tokens/seq
    S, N = (64, 32) if reduced else (256, 64)
    return dict(B=B, H=H, K=K, hd=hd, page=page, NP=NP, T=NP * page,
                V=1024 if reduced else 4096, S=S, N=N)


def work(sh: dict, elem: int) -> dict:
    """Analytic (FLOPs, bytes) of each row's call at ``shapes``, q, the
    cache and the pages ``elem`` bytes an element (the int8 pool's
    payload 1 and its scales 4; the sampler's logits and the scan's
    inputs fp32, 4): each input read once, each output written once."""
    B, H, K, hd = sh["B"], sh["H"], sh["K"], sh["hd"]
    page, NP, T, V, S, N = (sh[k] for k in ("page", "NP", "T", "V", "S",
                                            "N"))
    f32 = 4
    attn_flops = 4.0 * B * H * T * hd       # qk^T + pv, 2 FLOP/MAC each
    qo_bytes = 2.0 * B * H * hd * elem      # q read + o write
    tables = B * NP * 4
    return {
        "flash_decode": (attn_flops, 2.0 * B * T * K * hd * elem + qo_bytes),
        "paged_fp": (attn_flops, 2.0 * B * NP * page * K * hd * elem
                     + tables + qo_bytes),
        "paged_int8": (attn_flops + 2.0 * B * T * K * hd * 2,  # k, v scaling
                       2.0 * B * NP * page * K * hd * 1        # int8 payload
                       + 2.0 * B * NP * page * K * f32         # scales
                       + tables + qo_bytes),
        "fused_sample": (12.0 * B * V,      # mask+scale+gumbel+argmax
                         B * V * f32 + B * 4),
        "ssm_scan": (6.0 * B * S * H * hd * N,
                     2.0 * B * S * H * hd * f32        # xdt read, y write
                     + 2.0 * B * S * N * f32 + B * S * H * f32),
    }


def bench(reduced=False, reps=5, peaks=None, *, device="cuda",
          time_fn=None, seed=0, log=print):
    """(rows, gates held). Rows are ``kernel_roofline``'s with the dtype
    that ran; the last is the summary."""
    dev = resolve_device(device)
    if peaks is None:
        peaks = measure_local_peaks(device=dev)
    if time_fn is None:
        def time_fn(fn):
            return timed_best(fn, reps=reps)
    sh = shapes(reduced)
    cost = work(sh, 4)
    B, H, K, hd = sh["B"], sh["H"], sh["K"], sh["hd"]
    page, NP, T, V, S, N = (sh[k] for k in ("page", "NP", "T", "V", "S",
                                            "N"))
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=dev)

    rows = []

    def row(name, fn, row_dtype):
        flops, nbytes = cost[name]
        r = kernel_roofline(name, flops=flops, bytes_moved=nbytes,
                            wall_s=time_fn(fn), peaks=peaks)
        r["dtype"] = row_dtype
        rows.append(r)
        log(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in r.items()}))
        return r

    # -- flash_decode: dense (B, T, K, hd) cache at one position -----------
    q = normal(B, 1, H, hd)
    k = normal(B, T, K, hd)
    v = normal(B, T, K, hd)
    row("flash_decode", lambda: ops.flash_decode(q, k, v, T - 1), "float32")

    # -- paged: pool of B*NP pages + garbage page 0 ------------------------
    P = 1 + B * NP
    kp = normal(P, page, K, hd)
    vp = normal(P, page, K, hd)
    tables = (1 + torch.arange(B * NP, dtype=torch.int32,
                               device=dev)).reshape(B, NP)
    pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
    fp = row("paged_fp", lambda: ops.paged_decode(q, kp, vp, tables, pos),
             "float32")

    # -- paged int8: the same pool quantized, per-(row,head) fp32 scales ---
    kq, ksc = kv_quant_ref(kp)
    vq, vsc = kv_quant_ref(vp)
    q8 = row("paged_int8",
             lambda: ops.paged_decode_quant(q, kq, vq, ksc, vsc, tables,
                                            pos), "int8")

    # -- fused sampling: (B, V) fp32 logits -> (B,) tokens on the device ---
    logits = normal(B, V)
    ar = torch.arange(B, device=dev)
    temp = torch.where(ar % 2 == 0, 0.0, 0.8).to(torch.float32)
    topk = torch.where(ar % 2 == 0, 0, 40).to(torch.int32)
    keys = torch.stack([torch.full((B,), 7, dtype=torch.int32, device=dev),
                        ar.to(torch.int32),
                        torch.zeros((B,), dtype=torch.int32, device=dev)],
                       dim=1)
    row("fused_sample",
        lambda: ops.fused_sample(logits, temp, topk, keys, vocab_size=V),
        "float32")

    # -- ssm_scan: the recurrent path's chunked SSD scan (fp32) ------------
    xdt = normal(B, S, H, hd)
    Bv = normal(B, S, N)
    Cv = normal(B, S, N)
    la = -torch.nn.functional.softplus(normal(B, S, H))
    row("ssm_scan", lambda: ops.ssm_scan(xdt, Bv, Cv, la)[0], "float32")

    names = {r["name"] for r in rows}
    summary = {
        "name": "summary", "reduced": reduced,
        "int8_bytes_vs_fp": round(q8["bytes"] / fp["bytes"], 4),
        "int8_bytes_target": 0.6,
        "int8_wall_vs_fp": round(q8["wall_s"] / fp["wall_s"], 3),
        "int8_wall_target": 2.5,
        "rows_present": len(names),
        **peaks.row(),
    }
    rows.append(summary)
    log(json.dumps(summary))
    ok = (names == set(ROWS)
          and all(r["wall_s"] > 0 for r in rows[:-1])
          and summary["int8_bytes_vs_fp"] <= 0.6
          and summary["int8_wall_vs_fp"] <= 2.5)
    return rows, ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="smaller shapes; same rows and gates")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced shapes with 2 timed calls a row")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--peak-bw-gbps", type=float, default=None,
                    help="override the measured copy bandwidth peak")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="override the measured matmul FLOP-rate peak")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    peaks = None
    if args.peak_bw_gbps or args.peak_tflops:
        m = measure_local_peaks(device=args.device)
        peaks = Peaks(
            flops=(args.peak_tflops * 1e12 if args.peak_tflops
                   else m.flops),
            hbm_bw=(args.peak_bw_gbps * 1e9 if args.peak_bw_gbps
                    else m.hbm_bw))
    rows, ok = bench(reduced=args.reduced or args.smoke,
                     reps=2 if args.smoke else args.reps, peaks=peaks,
                     device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
