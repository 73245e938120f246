"""Table I reproduction on the port: VF detach-attach vs pause-unpause
overhead (mirrors ``benchmarks/table1.py``: the same rows and JSON
lines).

Paper setup (§V): 1 PF exposing 32 VFs; 1/4/10 VFs attached to as many
VMs; a re-configuration cycle removes/pauses all VFs and attaches/unpauses
them again; avg of 100 runs. Here: a pool of 32 logical slots on one
device (the card, or the CPU with ``--device cpu``), one train tenant per
VF running the svff-bench workload (~512KB state, the paper's fast-VF-
memory analogue); the cycle is ``SVFFManager.reconf`` in both modes.
Timings are wall-clock, like the paper's ("real timings").

    python -m repro_torch.bench.table1 --device cuda --runs 10
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile

from repro_torch.configs import make_run_config
from repro_torch.configs.paper import PAPER_MAX_VFS
from repro_torch.core import DevicePool, SVFFManager, StagingEngine, Tenant
from repro_torch.device import resolve_device


def make_pool() -> DevicePool:
    """The PF: PAPER_MAX_VFS logical device slots, all on one device."""
    return DevicePool(devices=[f"benchdev{i}" for i in range(PAPER_MAX_VFS)],
                      max_vfs=PAPER_MAX_VFS)


def make_tenants(nvf: int, device) -> list:
    run = make_run_config("svff-bench", "train_4k", smoke=True)
    return [Tenant(f"vm{i}", run, local_batch=2, seq_len=16, seed=i,
                   device=device) for i in range(nvf)]


def devices_per_vf(nvf: int) -> int:
    return max(1, PAPER_MAX_VFS // max(nvf, 1) // 2)


def bench(runs: int, vf_counts=(1, 4, 10), compression="none",
          device="cuda") -> list:
    dev = resolve_device(device)
    rows = []
    for nvf in vf_counts:
        wd = tempfile.mkdtemp(prefix="svff_bench_")
        try:
            mgr = SVFFManager(make_pool(), workdir=wd,
                              staging=StagingEngine(compression=compression))
            tenants = make_tenants(nvf, dev)
            per = devices_per_vf(nvf)
            mgr.init(num_vfs=nvf, tenants=tenants, devices_per_vf=per)
            for tn in tenants:
                tn.run_steps(1)               # guests live during the cycle

            samples = {"pause": [], "detach": []}
            for r in range(runs):
                for mode, use_pause in (("detach", False), ("pause", True)):
                    t = mgr.reconf(num_vfs=nvf, use_pause=use_pause,
                                   devices_per_vf=per)
                    samples[mode].append(t["total"] * 1000.0)
            d_avg = statistics.mean(samples["detach"])
            d_std = statistics.stdev(samples["detach"]) if runs > 1 else 0.0
            p_avg = statistics.mean(samples["pause"])
            p_std = statistics.stdev(samples["pause"]) if runs > 1 else 0.0
            rows.append({
                "num_vf": nvf, "runs": runs, "compression": compression,
                "detach_attach_ms": d_avg, "detach_attach_std": d_std,
                "pause_unpause_ms": p_avg, "pause_unpause_std": p_std,
                "overhead_pct": 100.0 * (p_avg - d_avg) / d_avg,
                "ms_per_vf_delta": (p_avg - d_avg) / nvf,
            })
            # paper-faithful transparency check: every guest still live
            for tn in tenants:
                tn.run_steps(1)
                assert tn.status == "running"
        finally:
            shutil.rmtree(wd, ignore_errors=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--vfs", type=int, nargs="*", default=[1, 4, 10])
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)
    rows = bench(args.runs, tuple(args.vfs), args.compression, args.device)
    for r in rows:
        print(json.dumps(r))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
