"""Paper claim (1) on the port: "native performance ... no performance
loss" — a pause/unpause cycle must not change a train tenant's steady-
state step time. Also measures the staging engine's snapshot bandwidth
with and without ``qdma_pack`` int8 compression (mirrors
``benchmarks/throughput.py``: the same ``bench(steps)`` protocol and
report keys).

One train ``Tenant`` under ``SVFFManager`` (two VFs of four logical
slots of one device): 5 warm steps, ``steps`` timed, pause, unpause, 2
steps skipped (they rebuild what the pause dropped, as in the JAX
benchmark), ``steps`` timed again; then its state saved by a
``StagingEngine`` with compression none and int8. A step's time is
taken after the device finished it (``Tenant.run_steps`` synchronizes).

The default model is the JAX benchmark's, ``svff-bench`` at its smoke
widths; ``--arch``/``--full``/``--batch``/``--seq`` take another
(``--arch qwen3-0.6b --full --batch 4 --seq 512`` is a 7.15 GB train
state on the card).

    python -m repro_torch.bench.throughput --device cpu --smoke
    python -m repro_torch.bench.throughput --arch qwen3-0.6b --full \
        --batch 4 --seq 512
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

import torch

from repro_torch.configs import make_run_config
from repro_torch.core import DevicePool, SVFFManager, StagingEngine, Tenant
from repro_torch.device import resolve_device

WARM_STEPS = 5
SKIP_AFTER_UNPAUSE = 2


def make_tenant(run, device, local_batch: int, seq_len: int,
                tid: str = "vm0", seed: int = 0) -> Tenant:
    return Tenant(tid, run, local_batch=local_batch, seq_len=seq_len,
                  seed=seed, device=device)


def total_steps(steps: int) -> int:
    """Train steps the cycle runs in all (a never-paused twin runs as
    many to reach the same state)."""
    return WARM_STEPS + steps + SKIP_AFTER_UNPAUSE + steps


def attach(tn: Tenant, workdir: str) -> SVFFManager:
    """``tn`` under a manager of its own: two VFs of four logical slots
    of one device, as the JAX benchmark's eight-device pool."""
    pool = DevicePool([f"tpdev{i}" for i in range(8)], max_vfs=8)
    mgr = SVFFManager(pool, workdir=workdir)
    mgr.init(num_vfs=2, tenants=[tn], devices_per_vf=4)
    return mgr


def twin(tn: Tenant, steps: int, workdir: str, local_batch: int,
         seq_len: int) -> Tenant:
    """A never-paused twin of ``tn`` (its run and seed; ``tn``'s batch
    shape) that ran as many steps as ``cycle(tn, steps)``: the state the
    cycle must leave ``tn`` in, bit for bit."""
    tw = make_tenant(tn.run, tn.device, local_batch, seq_len,
                     tid=tn.tid + "_twin", seed=tn.run.seed)
    attach(tw, workdir)
    tw.run_steps(total_steps(steps))
    return tw


def cycle(tn: Tenant, steps: int, workdir: str) -> dict:
    """The pause/unpause cycle on ``tn`` (attached here) with its step
    times before and after; leaves ``tn`` attached and running."""
    mgr = attach(tn, workdir)
    tn.run_steps(WARM_STEPS)
    tn.step_times.clear()
    tn.run_steps(steps)
    before = statistics.median(tn.step_times)

    mgr.pause(tn)
    mgr.unpause(tn)
    tn.run_steps(SKIP_AFTER_UNPAUSE)
    tn.step_times.clear()
    tn.run_steps(steps)
    after = statistics.median(tn.step_times)
    return {"step_ms_before_pause": before * 1000,
            "step_ms_after_unpause": after * 1000,
            "pause_cycle_overhead_pct": 100 * (after - before) / before}


def snapshots(state) -> dict:
    """The state's snapshot bytes, ms and GB/s, plain vs qdma_pack int8."""
    out = {}
    for comp in ("none", "int8"):
        eng = StagingEngine(compression=comp, min_quant_size=1024)
        eng.save(state)
        st = eng.last_stats
        out[f"snapshot_{comp}_bytes"] = st.bytes_moved
        out[f"snapshot_{comp}_ms"] = st.seconds * 1000
        out[f"snapshot_{comp}_gbps"] = st.bandwidth_gbps
    out["compression_ratio"] = (out["snapshot_none_bytes"] /
                                out["snapshot_int8_bytes"])
    return out


def run_bench(steps: int = 20, *, arch: str = "svff-bench",
              smoke: bool = True, local_batch: int = 4, seq_len: int = 64,
              device="cuda", seed: int = 0):
    """(the report, the tenant after the cycle, still attached)."""
    dev = resolve_device(device)
    run = make_run_config(arch, "train_4k", smoke=smoke)
    tn = make_tenant(run, dev, local_batch, seq_len, seed=seed)
    with tempfile.TemporaryDirectory(prefix="svff_tp_") as wd:
        out = cycle(tn, steps, wd)
        out.update(snapshots(tn.export_state()))
    return out, tn


def bench(steps: int = 20, **kw) -> dict:
    return run_bench(steps, **kw)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--arch", default="svff-bench")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full widths (default: its smoke "
                         "widths, as the JAX benchmark runs svff-bench)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="a short run: 3 timed steps a window")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    row = bench(3 if args.smoke else args.steps, arch=args.arch,
                smoke=not args.full, local_batch=args.batch,
                seq_len=args.seq, device=args.device)
    print(json.dumps(row))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
