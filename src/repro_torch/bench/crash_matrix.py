"""Crash matrix on the port: crash points x seeds x policies, recovered
and verified (mirrors ``benchmarks/crash_matrix.py``: the same report
keys).

For every crash point (``repro_torch.sim.PORTED_POINTS``, the 19
windows of the core ops, request migration and the gang ops, as the JAX
benchmark runs them), for each seed and placement policy, the runner
kills the manager at that point mid-operation, rebuilds it
with ``SVFFManager.recover``, and asserts invariants I1-I8, recovery
idempotence (I9) and the cataloged outcome (rolled back == op never
issued, rolled forward == op fully applied), plus post-recovery
liveness. The sim tenants' state lives on ``--device``.

    python -m repro_torch.bench.crash_matrix --device cuda --seeds 3
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.sim import CRASH_POINTS, PORTED_POINTS, crash_matrix


def run_matrix(points, seeds, policies, device="cuda") -> dict:
    points = points or list(PORTED_POINTS)
    t0 = time.perf_counter()
    out = crash_matrix(points=points, seeds=range(seeds),
                       policies=policies, raise_on_fail=False,
                       device=device)
    wall = time.perf_counter() - t0

    # aggregate per (point, policy): the report stays compact
    rows: dict = {}

    def row_for(point, policy):
        return rows.setdefault((point, policy), {
            "point": point, "policy": policy,
            "outcome": CRASH_POINTS[point].outcome,
            "triggers": sorted(CRASH_POINTS[point].triggers),
            "seeds_ok": 0, "seeds_failed": 0})

    for c in out["cases"]:
        row_for(c["point"], c["policy"])["seeds_ok"] += 1
    for f in out["failures"]:
        row_for(f["point"], f["policy"])["seeds_failed"] += 1

    return {
        "protocol": {
            "seeds_per_cell": seeds,
            "policies": list(policies),
            "points": points,
            "device": str(device),
            "checks": ["I1-I8 via check_invariants", "I9 double-recover "
                       "fingerprint", "cataloged outcome", "step-counter "
                       "drift", "post-recovery liveness (pause/unpause/"
                       "step round-trip)"],
        },
        "matrix": [rows[k] for k in sorted(rows)],
        "failures": out["failures"],
        "summary": {**out["summary"], "wall_s": wall,
                    "all_green": not out["failures"]},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=20,
                    help="seeds per (point, policy) cell")
    ap.add_argument("--policies", nargs="*",
                    default=["first_fit", "best_fit", "fair_share"])
    ap.add_argument("--points", nargs="*", default=None,
                    help="crash points (default: all 19)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tenants' state (cuda, or cpu)")
    ap.add_argument("--out", default=None, help="JSON report path")
    args = ap.parse_args(argv)

    report = run_matrix(args.points, args.seeds, args.policies, args.device)
    for row in report["matrix"]:
        status = ("OK " if not row["seeds_failed"]
                  else f"FAIL({row['seeds_failed']})")
        print(f"{row['point']:26s} {row['policy']:10s} "
              f"{row['outcome']:8s} {status} "
              f"({row['seeds_ok']}/{row['seeds_ok'] + row['seeds_failed']} "
              f"seeds)")
    s = report["summary"]
    print(f"{s['num_cases']} cases, {s['num_failures']} failures, "
          f"{s['wall_s']:.1f}s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if report["summary"]["all_green"] else 1


if __name__ == "__main__":
    sys.exit(main())
