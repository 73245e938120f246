"""End-to-end training with checkpoint/restart fault tolerance
(mirrors ``repro.launch.train``: the same flags, plus ``--device``, and
the same ``metrics.jsonl`` lines and final JSON line).

Runs on the card unless ``--device cpu`` is given; one card holds the
whole state (the JAX launcher's local mesh is the unit mesh here).

Restart semantics: --resume finds the newest valid checkpoint (manifest is
written last, so a crash mid-save is invisible) and continues with
bit-identical data order (batches are a pure function of step).

    python -m repro_torch.launch.train --smoke --steps 30 --batch 8 \\
        --seq 64 --lr 3e-3 --warmup 5 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import (OptimizerConfig, SHAPES, list_archs,
                                 make_run_config)
from repro_torch.data.pipeline import Prefetcher, SyntheticSource
from repro_torch.device import resolve_device
from repro_torch.train.step import init_train_state, make_train_step


def build(args):
    overrides = {}
    if args.lr:
        overrides["optimizer"] = OptimizerConfig(lr=args.lr,
                                                 warmup=args.warmup)
    run = make_run_config(args.arch, args.shape, smoke=args.smoke,
                          microbatch=args.microbatch, **overrides)
    if args.batch or args.seq:
        shape = dataclasses.replace(
            run.shape,
            global_batch=args.batch or run.shape.global_batch,
            seq_len=args.seq or run.shape.seq_len)
        run = dataclasses.replace(run, shape=shape)
    return run


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args) -> dict:
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 logits in fp32
    run = build(args)
    store = CheckpointStore(os.path.join(args.workdir, "ckpt"),
                            keep=args.keep)
    step_fn = make_train_step(run, total_steps=args.steps)
    state = init_train_state(run, run.seed, device)
    start = 0
    if args.resume and store.latest() is not None:
        state = store.restore(store.latest(), state, device=device)
        start = int(state["step"])
        print(f"[train] resumed from step {start}", flush=True)

    src = SyntheticSource(run, batch_override=run.shape.global_batch,
                          seq_override=run.shape.seq_len)
    pf = Prefetcher(src, depth=2, device=device, start_step=start)
    log_path = os.path.join(args.workdir, "metrics.jsonl")
    os.makedirs(args.workdir, exist_ok=True)
    tokens_per_step = run.shape.global_batch * run.shape.seq_len
    t_start = time.perf_counter()
    last = {}
    try:
        for i in range(start, args.steps):
            step_idx, batch = pf.next()
            assert step_idx == i
            _sync(device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            _sync(device)
            dt = time.perf_counter() - t0
            last = {k: float(v) for k, v in metrics.items()}
            last.update(step=i + 1, step_s=dt,
                        tokens_per_s=tokens_per_step / dt)
            with open(log_path, "a") as f:
                f.write(json.dumps(last) + "\n")
            if args.log_every and (i + 1) % args.log_every == 0:
                print(f"[train] step {i+1} loss {last['loss']:.4f} "
                      f"({last['tokens_per_s']:.0f} tok/s)", flush=True)
            if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
                store.save_async(i + 1, state)
            if args.crash_at and (i + 1) == args.crash_at:
                print("[train] simulated crash", flush=True)
                store.wait()
                os._exit(17)        # hard kill: restart path must recover
    finally:
        pf.stop()
    store.wait()
    store.save(args.steps, state)
    last["wall_s"] = time.perf_counter() - t_start
    return last


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_archs())
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate a hard crash after N steps (testing)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    return ap


def main(argv=None):
    last = train(parser().parse_args(argv))
    print(json.dumps(last))
    return 0


if __name__ == "__main__":
    sys.exit(main())
