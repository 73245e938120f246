"""Benchmark harness (mirrors ``benchmarks/run.py``) — one function per
paper table/figure.

Prints ``name,us_per_call,derived`` CSV (plus writes JSON under
results/bench_torch/). Each table runs its driver,
``repro_torch.bench.<name>``, in a subprocess on ``--device`` (the card by
default):

  table1      paper Table I  — detach/attach vs pause/unpause cycle, 1/4/10
  table2      paper Table II — per-macro-step breakdown of one cycle
  throughput  paper claim §I(1) — step time before/after a pause cycle,
              + qdma_pack snapshot compression ratio
  roofline    the aggregated dry-run table (results/dryrun_torch; a row
              of more than one card is a model, not a measurement)

    python -m repro_torch.bench.run --only table2 --device cuda
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
OUT = os.path.join(ROOT, "results", "bench_torch")


def _sub(mod, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    p = subprocess.run([sys.executable, "-m", mod, *args],
                       capture_output=True, text=True, env=env,
                       timeout=7200)
    if p.returncode != 0:
        raise RuntimeError(f"{mod} failed:\n{p.stderr[-3000:]}")
    rows = []
    for line in p.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            rows.append(json.loads(line))
    return rows


def table1(runs: int = 30, device: str = "cuda") -> list:
    os.makedirs(OUT, exist_ok=True)
    rows = _sub("repro_torch.bench.table1", "--runs", str(runs),
                "--device", device,
                "--out", os.path.join(OUT, "table1.json"))
    csv = []
    for r in rows:
        csv.append(("table1/detach_attach_%dvf" % r["num_vf"],
                    r["detach_attach_ms"] * 1000.0,
                    f"std_ms={r['detach_attach_std']:.1f}"))
        csv.append(("table1/pause_unpause_%dvf" % r["num_vf"],
                    r["pause_unpause_ms"] * 1000.0,
                    f"overhead_pct={r['overhead_pct']:.2f}"))
    return csv


def table2(device: str = "cuda") -> list:
    os.makedirs(OUT, exist_ok=True)
    rows = _sub("repro_torch.bench.table2", "--device", device,
                "--out", os.path.join(OUT, "table2.json"))
    csv = []
    for r in rows:
        for mode in ("DA", "PU"):
            for step in ("rescan", "remove_vf", "change_num_vf", "add_vf"):
                csv.append((f"table2/{mode}_{step}_{r['num_vf']}vf",
                            r[f"{mode}_{step}_ms"] * 1000.0,
                            f"total_ms={r[f'{mode}_total_ms']:.1f}"))
    return csv


def throughput(device: str = "cuda") -> list:
    os.makedirs(OUT, exist_ok=True)
    rows = _sub("repro_torch.bench.throughput", "--device", device,
                "--out", os.path.join(OUT, "throughput.json"))
    r = rows[0]
    return [
        ("throughput/step_before_pause", r["step_ms_before_pause"] * 1000,
         f"after_pct={r['pause_cycle_overhead_pct']:+.2f}"),
        ("throughput/step_after_unpause", r["step_ms_after_unpause"] * 1000,
         "native_perf_claim"),
        ("throughput/snapshot_none", r["snapshot_none_ms"] * 1000,
         f"bytes={r['snapshot_none_bytes']}"),
        ("throughput/snapshot_int8", r["snapshot_int8_ms"] * 1000,
         f"ratio={r['compression_ratio']:.2f}"),
    ]


def roofline() -> list:
    from repro_torch.bench.roofline_table import load_rows
    rows = load_rows()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "roofline.json"), "w") as f:
        json.dump(rows, f, indent=1)
    csv = []
    for r in rows:
        if r["status"] != "ok":
            continue
        csv.append((f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
                    r["step_s"] * 1e6,
                    f"bound={r['bound']};mfu={r['mfu']*100:.1f}%"))
    return csv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    choices=["table1", "table2", "throughput", "roofline"])
    ap.add_argument("--runs", type=int, default=30,
                    help="table1 cycle repetitions (paper: 100)")
    ap.add_argument("--device", default="cuda",
                    help="the tables' device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    benches = {"table1": lambda: table1(args.runs, args.device),
               "table2": lambda: table2(args.device),
               "throughput": lambda: throughput(args.device),
               "roofline": roofline}
    names = [args.only] if args.only else list(benches)
    print("name,us_per_call,derived")
    for n in names:
        for row in benches[n]():
            print(f"{row[0]},{row[1]:.1f},{row[2]}", flush=True)


if __name__ == "__main__":
    main()
