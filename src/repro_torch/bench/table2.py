"""Table II reproduction on the port: per-macro-step timings of one
reconfiguration cycle (rescan / remove VF / change #VF / add VF),
detach-attach vs pause-unpause, for 1/4/10 VFs — a single representative
run, like the paper's ("these timings represent one particular run").
Mirrors ``benchmarks/table2.py``: the same rows and JSON lines, over the
pool and tenants of ``repro_torch.bench.table1``.

    python -m repro_torch.bench.table2 --device cuda
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from repro_torch.bench.table1 import devices_per_vf, make_pool, make_tenants
from repro_torch.core import SVFFManager
from repro_torch.device import resolve_device

STEPS = ("rescan", "remove_vf", "change_num_vf", "add_vf", "total")


def bench(vf_counts=(1, 4, 10), warmup: int = 2, device="cuda") -> list:
    dev = resolve_device(device)
    rows = []
    for nvf in vf_counts:
        wd = tempfile.mkdtemp(prefix="svff_t2_")
        try:
            mgr = SVFFManager(make_pool(), workdir=wd)
            tenants = make_tenants(nvf, dev)
            per = devices_per_vf(nvf)
            mgr.init(num_vfs=nvf, tenants=tenants, devices_per_vf=per)
            for _ in range(warmup):           # steady-state, like the paper
                mgr.reconf(num_vfs=nvf, use_pause=True, devices_per_vf=per)
                mgr.reconf(num_vfs=nvf, use_pause=False, devices_per_vf=per)
            da = mgr.reconf(num_vfs=nvf, use_pause=False, devices_per_vf=per)
            pu = mgr.reconf(num_vfs=nvf, use_pause=True, devices_per_vf=per)
        finally:
            shutil.rmtree(wd, ignore_errors=True)
        row = {"num_vf": nvf}
        for s in STEPS:
            row[f"DA_{s}_ms"] = da[s] * 1000.0
            row[f"PU_{s}_ms"] = pu[s] * 1000.0
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vfs", type=int, nargs="*", default=[1, 4, 10])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)
    rows = bench(tuple(args.vfs), device=args.device)
    for r in rows:
        print(json.dumps(r))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
