#!/usr/bin/env python3
"""Does torch.profiler's record of one generate-path decode step hold the
step's ``flash_decode`` kernel? One NVIDIA GPU, several fresh processes.

    python3 tools/profiler_record.py [--procs 4] [--seed 0]

``chip_smoke.py``'s ``phase_generate`` profiles the last decode step of
the hybrid stack (jamba-1.5-large-398b-1p-dense at full width: B 4, a
dense cache of 1,024 positions, pos 511, one attention layer, so one
``flash_decode`` kernel among ~660 device events) and fails when the
record lacks that kernel. This script builds the kernels, then runs
``--procs`` child processes for each prelude, one after another; each
child runs its prelude, prefills the hybrid and takes two decode steps,
and then profiles the step at pos 511 (from a copy of the cache as it
was before it, so every session runs the same step) in sessions of
these kinds, in this order:

``cpu+cuda``   the session ``phase_generate`` takes (CPU and CUDA
               activities), three times;
``cuda``       CUDA activities only;
``padded``     CPU and CUDA, the step between two ~1 ms device sleeps
               (``torch.cuda._sleep``), so no kernel of the step lies
               near the session's start or end;
``bare``       three ``flash_decode`` calls at the step's shapes, alone.

The preludes: ``none`` (the child's first profiling is the step's),
``kernels`` (``chip_smoke.py``'s kernel phases before it, as ``main``
runs them: flash_decode, flash_attention with the other families' rows,
paged decode, fused_sample with seamless's vocabulary, ssm_scan) and
``kernels_nofam`` (the same without the other families' rows). For each
session a child reports the device events of ``prof.events()``, the
``flash_decode`` kernels among them and among the raw Kineto events
(hidden ones too), the flash_decode launches the wrapper counted, and the
names a session lacks against the fullest ``cpu+cuda`` record of the
child. The summary goes to stdout and, with each child's report, to
``chiprun_out/profiler_record.json``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRELUDES = ("none", "kernels", "kernels_nofam")


def device_names(torch, prof) -> list:
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def raw_kernels(torch, prof) -> dict:
    """flash_decode among Kineto's raw device events, hidden ones too."""
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    hidden = [e for e in ev if getattr(e, "is_hidden_event",
                                       lambda: False)()]
    return {"raw_device_events": len(ev), "raw_hidden": len(hidden),
            "raw_flash_decode": sum("flash_decode" in e.name() for e in ev),
            "raw_hidden_flash_decode": sum("flash_decode" in e.name()
                                           for e in hidden)}


def child(prelude: str, seed: int) -> dict:
    import dataclasses
    import torch
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_serve_steps
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if prelude != "none":
        fam = prelude == "kernels"
        timer = cs.Timer(torch)
        cfg = make_run_config("qwen3-0.6b", "decode_32k").model
        hcfg = make_run_config(cs.HYBRID, "decode_32k").model
        shapes = cs.family_attention_shapes(
            lambda a: make_run_config(a, "decode_32k").model) if fam else ()
        more = ((make_run_config("seamless-m4t-medium", "decode_32k").model,)
                if fam else ())
        cs.phase_flash_decode(torch, ops, timer, hcfg)
        cs.phase_flash_attention(torch, ops, timer, cfg, hcfg, shapes)
        cs.phase_paged_decode(torch, ops, timer, cfg, hcfg, seed)
        cs.phase_fused_sample(torch, ops, timer, cfg, hcfg, *more)
        cs.phase_ssm_scan(torch, ops, timer, hcfg)
        del timer
        torch.cuda.empty_cache()
    prelude_s = time.perf_counter() - t0

    run = make_run_config(cs.HYBRID, "decode_32k", seed=seed)
    model = build_model(run)
    params = model.init(seed=seed, device="cuda")
    prefill, decode = make_serve_steps(run)
    B, S0, T, P = 4, 384, 1024, 511
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, run.model.vocab_size, (B, P + 1), generator=g,
                         device="cuda")
    cache, _ = prefill(params, {"tokens": toks[:, :S0]})
    dense = model.init_cache(dataclasses.replace(run.shape, seq_len=T,
                                                 global_batch=B),
                             device="cuda")
    for blk, node in cache.items():
        for name, leaf in node.items():
            if name in ("k", "v"):
                dense[blk][name][:, :, :S0] = leaf
            else:
                dense[blk][name].copy_(leaf)
    del cache
    for t in range(S0, S0 + 2):
        _, dense = decode(params, dense, toks[:, t:t + 1], t)
    torch.cuda.synchronize()
    before = tree_map(lambda t: t.clone(), dense)
    attn = next(n for n in dense.values() if "k" in n)
    q = torch.randn((B, 1, run.model.num_heads, run.model.head_dim),
                    generator=g, device="cuda").bfloat16()

    def step():
        tree_map(lambda t, t0: t.copy_(t0), dense, before)
        decode(params, dense, toks[:, P:P + 1], P)

    def bare():
        for _ in range(3):
            ops.flash_decode(q, attn["k"][0], attn["v"][0], P)

    sessions = []
    cpu_cuda = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    plan = [("cpu+cuda", cpu_cuda, step, False)] * 3 + [
        ("cuda", [ProfilerActivity.CUDA], step, False),
        ("padded", cpu_cuda, step, True),
        ("bare", cpu_cuda, bare, False)]
    for kind, acts, fn, pad in plan:
        fn()                                  # warm, as a session's calls
        torch.cuda.synchronize()
        n0 = ops.LAUNCHES["flash_decode"]
        with profile(activities=acts) as prof:
            if pad:
                torch.cuda._sleep(2_000_000)  # ~1 ms at the H100's clocks
            fn()
            if pad:
                torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
        names = device_names(torch, prof)
        sessions.append({"kind": kind, "device_events": len(names),
                         "flash_decode": sum("flash_decode" in n
                                             for n in names),
                         "launched": ops.LAUNCHES["flash_decode"] - n0,
                         **raw_kernels(torch, prof), "_names": names})
    full = max((s for s in sessions if s["kind"] == "cpu+cuda"),
               key=lambda s: s["device_events"])
    ref = collections.Counter(full["_names"])
    for s in sessions:
        names = s.pop("_names")
        if s["kind"] in ("cpu+cuda", "cuda", "padded"):
            lack = ref - collections.Counter(
                n for n in names if "Sleep" not in n and "sleep" not in n)
            s["lacks"] = {n[:120]: c for n, c in lack.items()}
    return {"prelude": prelude, "prelude_s": prelude_s,
            "sessions": sessions,
            "missed": any(s["flash_decode"] < s["launched"]
                          for s in sessions)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", choices=PRELUDES)
    args = ap.parse_args()
    if args.child:
        print("RESULT " + json.dumps(child(args.child, args.seed)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profiler_record: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, torch.__version__, torch.version.cuda, flush=True)
    build.build()
    reports = []
    for i in range(args.procs):
        for prelude in PRELUDES:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child", prelude, "--seed",
                                str(args.seed)], capture_output=True,
                               text=True, timeout=600)
            line = [ln for ln in p.stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if p.returncode or not line:
                print(f"child {prelude} #{i} failed rc={p.returncode}: "
                      f"{p.stderr[-2000:]}", flush=True)
                reports.append({"prelude": prelude, "failed": True})
                continue
            rep = json.loads(line[0][len("RESULT "):])
            rep["wall_s"] = time.perf_counter() - t0
            reports.append(rep)
            print(f"{prelude} #{i} ({rep['wall_s']:.0f} s): " + " | ".join(
                f"{s['kind']} {s['flash_decode']}/{s['launched']} fd of "
                f"{s['device_events']} ev (raw {s['raw_flash_decode']} fd, "
                f"{s['raw_hidden']} hidden)" for s in rep["sessions"]),
                flush=True)
            for s in rep["sessions"]:
                if s.get("lacks"):
                    print(f"    {s['kind']} lacks {json.dumps(s['lacks'])}",
                          flush=True)
    summary = {p: {"children": sum(r["prelude"] == p and not r.get("failed")
                                   for r in reports),
                   "missed": sum(r["prelude"] == p and bool(r.get("missed"))
                                 for r in reports)} for p in PRELUDES}
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profiler_record.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "summary": summary, "children": reports}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
