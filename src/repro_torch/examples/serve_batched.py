"""Serve a small model with batched requests — including a pause
mid-serving: the engine is paused (requests keep queueing, nothing is
dropped), the pool would be repartitioned, and serving resumes (mirrors
``examples/serve_batched.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import make_run_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    return ap


def make_requests(vocab: int) -> list:
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab,
                                               int(rng.integers(4, 10))),
                    max_new_tokens=6)
            for i in range(10)]


def serve(run, params, device) -> list:
    """The example's traffic on ``params``: six requests, four waves, a
    pause while four more arrive, then serve until all are done. Returns
    the requests (their ``out`` tokens)."""
    eng = ServeEngine(run, params, device=device, slots=4, max_len=64)
    reqs = make_requests(run.model.vocab_size)
    for r in reqs[:6]:
        eng.submit(r)

    t0 = time.perf_counter()
    for _ in range(4):              # serve a few waves
        eng.step()

    # --- reconfiguration arrives mid-serving -------------------------------
    eng.pause()
    print(f"[pause] engine paused after {time.perf_counter()-t0:.2f}s; "
          f"{sum(r.done for r in reqs)} done, queue keeps accepting:")
    for r in reqs[6:]:
        eng.submit(r)               # requests arrive WHILE paused
    print(f"        queued while paused: {len(eng.queue)}")
    time.sleep(0.1)                 # (the pool would repartition here)
    eng.unpause()

    steps = 0
    while (eng.step() or eng.queue) and steps < 500:
        steps += 1
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    dt = time.perf_counter() - t0
    print(f"[done] {done}/{len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s), {steps} decode steps after resume")
    if done != len(reqs):
        raise RuntimeError(f"{len(reqs) - done} requests did not finish")
    return reqs


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    run = make_run_config("qwen3-0.6b", "decode_32k", smoke=True)
    params = build_model(run).init(seed=0, device=args.device)
    return serve(run, params, args.device)


if __name__ == "__main__":
    main()
