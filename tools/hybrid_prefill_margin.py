#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s ``HYBRID_MARGIN``, on one NVIDIA
GPU: the hybrid prefill check (``phase_family_prefill`` with the SSM
states: the kernel path and the plain bf16 path, each against the plain
path with fp32 compute)
at several seeds of weights and prompts, and at seed 0 with the kernel
path perturbed in ways the check should reject.

    python3 tools/hybrid_prefill_margin.py [--seeds 0 1 2 3]

Prints one line per reading, the ratios the check holds (kernel path's
distance over the plain path's, for the logits and the mean SSM state)
and whether ``HYBRID_MARGIN`` passes it; writes everything to
``chiprun_out/hybrid_prefill_margin.json``. Imports only torch, numpy,
``chip_smoke`` and the port.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ratios(res):
    return {S: {"logits": r["kernel"]["logits"] / r["plain"]["logits"],
                "ssm_mean": r["kernel"]["ssm_mean"] / r["plain"]["ssm_mean"]}
            for S, r in res.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("hybrid_prefill_margin: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import build, ops
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    build.build()
    margin = cs.HYBRID_MARGIN
    run = make_run_config(cs.HYBRID, "decode_32k")
    scan, attn = ops.ssm_scan, ops.flash_attention

    def noisy(t, eps):
        return t * (1 + eps * torch.randn_like(t.float())).to(t.dtype)

    # each perturbation acts on the kernel path only (backend "auto")
    def scan_noise(eps):
        def f(*a, backend="auto", **k):
            y, st = scan(*a, backend=backend, **k)
            if backend != "auto":
                return y, st
            return noisy(y, eps), noisy(st, eps)
        return f

    def scan_scale(eps):
        def f(*a, backend="auto", **k):
            y, st = scan(*a, backend=backend, **k)
            return (y * (1 + eps), st * (1 + eps)) if backend == "auto" \
                else (y, st)
        return f

    def scan_swap(x, b, c, la, backend="auto", **k):
        if backend != "auto":
            return scan(x, b, c, la, backend=backend, **k)
        return scan(x, c, b, la, backend=backend, **k)

    def scan_no_carry(x, b, c, la, backend="auto", chunk=128):
        if backend != "auto" or x.shape[1] <= chunk:
            return scan(x, b, c, la, backend=backend, chunk=chunk)
        ys = []
        for s in range(0, x.shape[1], chunk):
            y, st = scan(*(t[:, s:s + chunk].contiguous()
                           for t in (x, b, c, la)), chunk=chunk)
            ys.append(y)
        return torch.cat(ys, 1), st

    def attn_noise(eps):
        def f(*a, backend="auto", **k):
            o = attn(*a, backend=backend, **k)
            return noisy(o, eps) if backend == "auto" else o
        return f

    controls = {
        **{f"ssm_scan y, state x (1 + {e} randn)": ("ssm_scan", scan_noise(e))
           for e in (0.01, 0.03, 0.1)},
        **{f"ssm_scan y, state x {1 + e}": ("ssm_scan", scan_scale(e))
           for e in (0.01, 0.03)},
        "ssm_scan B and C swapped": ("ssm_scan", scan_swap),
        "ssm_scan carries no state across chunks": ("ssm_scan",
                                                    scan_no_carry),
        **{f"flash_attention out x (1 + {e} randn)":
           ("flash_attention", attn_noise(e)) for e in (0.03, 0.1)}}
    originals = {"ssm_scan": scan, "flash_attention": attn}
    out = {"card": card, "margin": margin, "seeds": {}, "controls": {}}

    def reading(params, seed):
        cs.HYBRID_MARGIN = float("inf")      # record; judged below
        try:
            res = cs.phase_family_prefill(
                torch, ops, run, params, seed, (100, 384), states=True,
                floor=0.0)["rel_err"]
        finally:
            cs.HYBRID_MARGIN = margin
        rat = ratios(res)
        ok = all(v <= margin for r in rat.values() for v in r.values())
        return {"readings": res, "ratios": rat, "passes": ok}

    for seed in args.seeds:
        params = build_model(run).init(seed=seed, device="cuda")
        r = out["seeds"][seed] = reading(params, seed)
        print(f"seed {seed}: ratios {json.dumps(r['ratios'])} | passes "
              f"{r['passes']}", flush=True)
        if seed == args.seeds[0]:
            for name, (fn, bad) in controls.items():
                setattr(ops, fn, bad)
                torch.manual_seed(0)
                try:
                    r = out["controls"][name] = reading(params, seed)
                finally:
                    setattr(ops, fn, originals[fn])
                print(f"control {name}: ratios {json.dumps(r['ratios'])} | "
                      f"passes {r['passes']}", flush=True)
        del params
        cs.release(torch)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "hybrid_prefill_margin.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
