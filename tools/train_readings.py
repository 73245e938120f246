#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s training phases, on one card:

  lr     ``launch.train`` at qwen3-0.6b's full width (batch 4 x 512,
         30 steps, warmup 5) at lr 3e-3, 1e-3, 3e-4 and 1e-4: each
         step's loss and grad norm, the first and last five steps' mean
         loss against ln V (why ``TRAIN_LR`` is 1e-4)
  twins  two undisturbed full-width train tenants from one seed, six
         steps each, without and with ``torch.use_deterministic_
         algorithms`` (and ``CUBLAS_WORKSPACE_CONFIG=:4096:8``): are
         their losses and every leaf of their states bit-equal (why the
         transparency check runs without deterministic mode)
  profile one full-width train step (after two warm ones) under
         torch.profiler: its wall time, the card's busy share and the
         kernels by device time

    python3 tools/train_readings.py    # one card, about 3 minutes

Writes ``chiprun_out/train_readings.json``; every line printed carries
the card's name and power limit.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

LRS = ("3e-3", "1e-3", "3e-4", "1e-4")


def lr_curves(torch, card, workdir) -> dict:
    from repro_torch.launch import train as launch
    out = {}
    for lr in LRS:
        wd = os.path.join(workdir, lr)
        args = launch.parser().parse_args([
            "--arch", cs.TRAIN_ARCH, "--batch", str(cs.TRAIN_BATCH),
            "--seq", str(cs.TRAIN_SEQ), "--steps", "30", "--lr", lr,
            "--warmup", "5", "--workdir", wd, "--checkpoint-every", "0",
            "--log-every", "0", "--device", "cuda"])
        launch.train(args)
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        shutil.rmtree(wd, ignore_errors=True)
        loss = [m["loss"] for m in lines]
        r = {"loss": loss, "grad_norm": [m["grad_norm"] for m in lines],
             "first5": sum(loss[:5]) / 5, "last5": sum(loss[-5:]) / 5,
             "ln_v": math.log(launch.build(args)[0].model.vocab_size)}
        out[lr] = r
        cs.log(f"lr {lr}: first five {r['first5']:.4f}, last five "
               f"{r['last5']:.4f} (ln V {r['ln_v']:.4f}); losses "
               + ", ".join(f"{x:.3f}" for x in loss) + f" | {card}")
        cs.release(torch)
    return out


def twins(torch, card, workdir, det: bool) -> dict:
    from repro_torch.configs import make_run_config
    from repro_torch.core import SVFFManager
    from repro_torch.tree import flatten
    run = make_run_config(cs.TRAIN_ARCH, "train_4k", seed=0)
    if det:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        losses, states = [], []
        for i in range(2):
            mgr = SVFFManager(cs.train_pool(),
                              workdir=os.path.join(workdir, f"{det}{i}"))
            tn = cs.train_tenant(run, f"twin{i}", 0)
            mgr.init(1, [tn])
            losses.append([tn.run_steps(1)["loss"] for _ in range(6)])
            states.append(tn)
    finally:
        if det:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = True
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
    a, b = (flatten(t.export_state())[0] for t in states)
    diff = [p for (p, x), (_, y) in zip(a, b)
            if not cs.bits_equal(torch, x, y)]
    r = {"deterministic": det, "losses": losses,
         "losses_equal": losses[0] == losses[1], "leaves": len(a),
         "leaves_differing": diff}
    cs.log(f"twins, deterministic {det}: losses "
           f"{'bit-equal' if r['losses_equal'] else 'DIFFER'} {losses} | "
           f"{len(diff)} of {len(a)} leaves differ | {card}")
    del a, b, states
    cs.release(torch)
    return r


def profile_step(torch, card) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import make_run_config
    from repro_torch.train.step import init_train_state, make_train_step
    run = make_run_config(cs.TRAIN_ARCH, "train_4k", seed=0)
    state = init_train_state(run, 0, "cuda")
    step = make_train_step(run, total_steps=30)
    batches = [cs.train_batch(torch, run, i) for i in range(3)]
    for b in batches[:2]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batches[2])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": e.key, "calls": e.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    r = {"wall_ms": wall_ms, "device_busy_ms": busy,
         "device_busy_share": busy / wall_ms,
         "kernel_launches": sum(r["calls"] for r in rows), "kernels": rows}
    cs.log(f"profiled train step: {wall_ms:.1f} ms wall, the card busy "
           f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), "
           f"{r['kernel_launches']} device events | {card}")
    for k in rows[:12]:
        cs.log(f"  {k['device_ms']:8.3f} ms {k['calls']:6d} calls  "
               f"{k['name'][:90]}")
    del state
    cs.release(torch)
    return r


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_readings: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cs.log(card)
    build.build()
    workdir = tempfile.mkdtemp(prefix="train_readings_")
    try:
        out = {"card": card, "lr": lr_curves(torch, card, workdir),
               "twins": [twins(torch, card, workdir, det)
                         for det in (False, True)],
               "profile": profile_step(torch, card)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train_readings.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
