"""Scenario sweep on the port: throughput + reconf latency of the
management plane, per placement policy, over many seeded randomized
scenarios (mirrors ``benchmarks/scenario_sweep.py``: the same report
keys).

Runs N deterministic scenarios (``repro_torch.sim``) per policy against
the port's real SVFFManager stack (simulated device tokens, sim tenants
whose state lives on ``--device``) and reports, as JSON:

  ops/sec               management-op throughput (wall clock)
  reconf p50/p95 (ms)   percentiles of the Table-II `total` across every
                        reconfiguration cycle executed in the sweep
  rejected              chaos-op rejections (all atomic, invariant-checked)

Every invariant is checked after every op; a violation raises.

    python -m repro_torch.bench.scenario_sweep --device cuda --scenarios 100
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from repro_torch.sim import ScenarioConfig, ScenarioRunner


def sweep(policies, scenarios: int, num_ops: int, num_devices: int,
          seed0: int = 0, device="cuda", serve_rate: float = 0.0,
          crash_rate: float = 0.0) -> dict:
    report = {"config": {"scenarios_per_policy": scenarios,
                         "num_ops": num_ops, "num_devices": num_devices,
                         "seed0": seed0, "device": str(device),
                         "serve_rate": serve_rate,
                         "crash_rate": crash_rate},
              "policies": {}}
    for policy in policies:
        ops = ok = rejected = 0
        reconf_ms = []
        t0 = time.perf_counter()
        for i in range(scenarios):
            res = ScenarioRunner(ScenarioConfig(
                seed=seed0 + i, policy=policy, num_ops=num_ops,
                num_devices=num_devices, serve_rate=serve_rate,
                crash_rate=crash_rate), device=device).run()
            ops += len(res.ops)
            ok += res.num_ok
            rejected += res.num_rejected
            reconf_ms += [t["total"] * 1e3 for t in res.reconf_timings]
        wall = time.perf_counter() - t0
        report["policies"][policy] = {
            "scenarios": scenarios,
            "ops": ops,
            "ops_ok": ok,
            "rejected": rejected,
            "wall_s": wall,
            "ops_per_sec": ops / wall,
            "reconfs": len(reconf_ms),
            "reconf_p50_ms": (float(np.percentile(reconf_ms, 50))
                              if reconf_ms else None),
            "reconf_p95_ms": (float(np.percentile(reconf_ms, 95))
                              if reconf_ms else None),
        }
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenarios", type=int, default=1000,
                    help="scenarios per policy")
    ap.add_argument("--ops", type=int, default=24, help="ops per scenario")
    ap.add_argument("--devices", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policies", nargs="*",
                    default=["first_fit", "best_fit", "fair_share"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tenants' state (cuda, or cpu)")
    ap.add_argument("--out", default=None, help="JSON report path")
    args = ap.parse_args(argv)

    report = sweep(args.policies, args.scenarios, args.ops, args.devices,
                   seed0=args.seed, device=args.device)
    for policy, row in report["policies"].items():
        p50, p95 = row["reconf_p50_ms"], row["reconf_p95_ms"]
        lat = (f"reconf p50={p50:.2f}ms p95={p95:.2f}ms"
               if p50 is not None else "no reconfs")
        print(f"{policy:12s} {row['ops_per_sec']:8.1f} ops/s  {lat}  "
              f"({row['reconfs']} reconfs, {row['rejected']} rejected)")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    else:
        print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
