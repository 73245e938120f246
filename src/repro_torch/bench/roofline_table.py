"""Roofline aggregation (mirrors ``benchmarks/roofline_table.py``): read
results/dryrun_torch/*.json (written by ``repro_torch.launch.dryrun``)
into the roofline table — per (arch x shape x mesh): three terms,
dominant bound, MODEL_FLOPS/counted flops, MFU at roofline. A row of a
mesh of more than one card is a model, not a measurement.

    python -m repro_torch.bench.roofline_table --markdown
"""
import argparse
import json
import os
import sys

from repro_torch.launch.dryrun import RESULTS_DIR as DRYRUN_DIR


def load_rows(d: str = DRYRUN_DIR, mesh_filter=("single", "multi")) -> list:
    rows = []
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(d, fn)) as f:
            r = json.load(f)
        if r.get("mesh") not in mesh_filter:
            continue
        if r.get("status") != "ok":
            rows.append({"arch": r["arch"], "shape": r["shape"],
                         "mesh": r.get("mesh"), "status": r["status"],
                         "reason": r.get("reason", r.get("error", ""))})
            continue
        rf = r["roofline"]
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "status": "ok", "chips": r["chips"],
            "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
            "collective_s": rf["collective_s"], "bound": rf["bound"],
            "step_s": rf["step_s"], "mfu": rf["mfu"],
            "useful_flops_frac": rf["useful_flops_frac"],
            "mem_per_dev_gib": (r["memory"]["argument_bytes"] +
                                r["memory"]["temp_bytes"]) / 2**30,
            "compile_s": r["compile_s"],
        })
    return rows


def markdown(rows) -> str:
    hdr = ("| arch | shape | mesh | compute_s | memory_s | collective_s | "
           "bound | step_s | useful | MFU | mem/dev GiB |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for r in rows:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"— | — | — | {r['status']} |  |  |  |  |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | **{r['bound']}** "
            f"| {r['step_s']:.4f} | {r['useful_flops_frac']:.2f} "
            f"| {r['mfu']*100:.1f}% | {r['mem_per_dev_gib']:.2f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DRYRUN_DIR)
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows = load_rows(args.dir)
    if args.markdown:
        print(markdown(rows))
    else:
        for r in rows:
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
