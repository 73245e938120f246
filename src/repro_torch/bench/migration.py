"""Request live migration under load on the port — zero loss, bounded
stall, and scale-in under load (mirrors ``benchmarks/migration.py``: the
same protocol, gates and report keys).

The claims under test:

  1. zero loss / token identity — a run that live-migrates in-flight
     requests between engines every few ticks completes every offered
     request with EXACTLY the token stream of an undisturbed run (the
     shipped KV block chain is bit-exact, the sampler counter-seeded);
  2. bounded stall — a migrating request's slot is frozen only while the
     synchronous hand-off runs, so the per-migration stall (decode ticks
     a frozen slot sat unservable) is bounded by ``STALL_BOUND``;
  3. scale-in under load — draining a BUSY engine by migrating its
     in-flight work (``ServeFleet.scale_in``) must not tax the requests
     that never migrated: their inter-token cadence stays within
     ``ITL_RATIO_TARGET`` x the steady-state p95.

Three runs over the SAME deterministic arrival schedule on a two-engine
paged fleet: ``steady`` (no interference; the token oracle), ``migrate``
(every ``--migrate-every`` ticks one in-flight request live-migrates from
the busier engine to the other) and ``scalein`` (at the trace midpoint
``scale_in`` parks engine 1 while it is busy). Latency is in TICKS (fleet
steps); wall-clock times ride along.

    python -m repro_torch.bench.migration --device cpu --smoke
    python -m repro_torch.bench.migration                  # full width
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import make_run_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request
from repro_torch.serve.fleet import ServeFleet
from repro_torch.serve.paged import RequestRejected
from repro_torch.serve.telemetry import percentile

STALL_BOUND = 2.0        # frozen-slot ticks tolerated per migration
ITL_RATIO_TARGET = 1.1   # non-migrated cadence vs steady-state p95


def make_request(rng, vocab, rid, max_new):
    # fixed prompt length: one prefill shape per engine
    return Request(rid=rid, prompt=rng.integers(0, vocab, 8),
                   max_new_tokens=max_new)


def warm_fleet(fleet, vocab, max_new):
    rng = np.random.default_rng(99)
    for tn in fleet.tenants.values():
        tn.engine.submit(Request(rid=900_000 + fleet._order[tn.tid],
                                 prompt=rng.integers(0, vocab, 8),
                                 max_new_tokens=max(max_new, 24)))
        tn.engine.run_until_idle()


def drive(fleet, ticks, rng, vocab, *, max_new, arrive_every,
          migrate_every=0, scale_in_at=None, max_drain_ticks=2000):
    """One run. Returns (records, migrated_rids, rejected, wall_s).
    Arrivals depend only on the tick index, so every mode sees the same
    request at the same tick with the same prompt."""
    live, finished, migrated = [], [], set()
    rejected = 0
    t0 = time.perf_counter()

    def poll(tick):
        for rec in list(live):
            r = rec["req"]
            if rec["first_tick"] is None and r.out:
                rec["first_tick"] = tick
            if r.done:
                rec["done_tick"] = tick
                rec["tokens"] = len(r.out)
                rec["out"] = list(r.out)
                finished.append(rec)
                live.remove(rec)

    def one_migration():
        running = sorted(
            (tn for tn in fleet.tenants.values()
             if tn.status == "running"),
            key=lambda tn: fleet._order[tn.tid])
        if len(running) < 2:
            return
        src = max(running,
                  key=lambda tn: (sum(r is not None
                                      for r in tn.engine.active),
                                  -fleet._order[tn.tid]))
        dst = next(tn for tn in running if tn.tid != src.tid)
        rid = src.peek_migratable()
        if rid is not None:
            if fleet.migrate_request(src.tid, dst.tid, rid) is not None:
                migrated.add(rid)

    tick = 0
    for tick in range(ticks):
        if tick % arrive_every == 0:
            r = make_request(rng, vocab, tick, max_new)
            r.t_submit = time.perf_counter()
            try:
                fleet.submit(r)
                live.append({"req": r, "submit_tick": tick,
                             "first_tick": None})
            except RequestRejected:
                rejected += 1
        if migrate_every and tick and tick % migrate_every == 0:
            one_migration()
        if scale_in_at is not None and tick == scale_in_at:
            victim = fleet.tenants["serve1"]
            # the in-flight slots about to live-migrate (queued work
            # moves for free and does not count as migrated)
            migrated |= {r.rid for r in victim.engine.active
                         if r is not None and not r.done}
            fleet.scale_in("serve1")
        fleet.step()
        poll(tick)
    while live and tick < ticks + max_drain_ticks:
        tick += 1
        fleet.step()
        poll(tick)
    if live:
        raise RuntimeError("trace left stranded work")
    res = fleet.drain()
    if not res.drained:
        raise RuntimeError("fleet did not drain after the trace")
    return finished, migrated, rejected, time.perf_counter() - t0


def row_for(name, recs, migrated, rejected, wall, fleet):
    def itl(rec):
        return ((rec["done_tick"] - rec["first_tick"])
                / max(rec["tokens"] - 1, 1))
    plain = [rec for rec in recs if rec["req"].rid not in migrated]
    moved = [rec for rec in recs if rec["req"].rid in migrated]
    stall = sum(tn.engine.stats["migration_stall_ticks"]
                for tn in fleet.tenants.values())
    desc = fleet.telemetry.describe()
    agg = {k: sum(d[k] for d in desc.values())
           for k in ("migrations_attempted", "migrations_completed",
                     "migrations_aborted", "migration_blocks")}
    return {"trace": name, "completed": len(recs), "rejected": rejected,
            "migrated_requests": len(moved),
            "itl_ticks_p95": round(percentile([itl(r) for r in recs],
                                              0.95), 3),
            "itl_ticks_p95_nonmigrated":
                round(percentile([itl(r) for r in plain], 0.95), 3),
            "itl_ticks_p95_migrated":
                round(percentile([itl(r) for r in moved], 0.95), 3),
            "ttft_ticks_p95": round(percentile(
                [r["first_tick"] - r["submit_tick"] for r in recs],
                0.95), 3),
            "migration_stall_ticks": stall,
            "wall_s": round(wall, 3), **agg}


def bench(run, params, device, *, ticks=48, max_new=10, slots=8,
          slo_max_load=16, arrive_every=2, migrate_every=5, seed=0,
          log=print) -> list:
    vocab = run.model.vocab_size
    rows = [{"name": "protocol", "ticks": ticks, "max_new": max_new,
             "slots": slots, "slo_max_load": slo_max_load,
             "arrive_every": arrive_every,
             "migrate_every": migrate_every,
             "stall_bound": STALL_BOUND,
             "itl_ratio_target": ITL_RATIO_TARGET, "device": str(device),
             "model": run.model.name}]
    log(json.dumps(rows[0]))
    outs, by = {}, {}
    modes = (("steady", {}), ("migrate", {"migrate_every": migrate_every}),
             ("scalein", {"scale_in_at": ticks // 2}))
    for name, kw in modes:
        workdir = tempfile.mkdtemp(prefix="svff_mig_")
        try:
            fleet = ServeFleet(run, params, num_engines=2, num_devices=4,
                               slots=slots, max_len=256, paged=True,
                               page_size=16, slo_max_load=slo_max_load,
                               device=device, workdir=workdir)
            warm_fleet(fleet, vocab, max_new)
            rng = np.random.default_rng(seed + 7)  # same prompts per tick
            recs, migrated, rejected, wall = drive(
                fleet, ticks, rng, vocab, max_new=max_new,
                arrive_every=arrive_every, **kw)
            row = row_for(name, recs, migrated, rejected, wall, fleet)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        rows.append(row)
        by[name] = row
        outs[name] = {rec["req"].rid: rec["out"] for rec in recs}
        log(json.dumps(row))

    steady_itl = by["steady"]["itl_ticks_p95"] or 1.0
    migs = max(by["migrate"]["migrations_completed"], 1)
    summary = {
        "name": "summary",
        "steady_itl_ticks_p95": steady_itl,
        "migrate_zero_loss": (
            by["migrate"]["rejected"] == 0
            and by["migrate"]["completed"] == by["steady"]["completed"]),
        "migrate_token_identical": outs["migrate"] == outs["steady"],
        "migrations_completed": by["migrate"]["migrations_completed"],
        "stall_ticks_per_migration": round(
            by["migrate"]["migration_stall_ticks"] / migs, 3),
        "stall_within_bound": (
            by["migrate"]["migration_stall_ticks"] / migs <= STALL_BOUND),
        "scalein_migrated_requests": by["scalein"]["migrated_requests"],
        "scalein_itl_ratio_nonmigrated": round(
            by["scalein"]["itl_ticks_p95_nonmigrated"] / steady_itl, 3),
    }
    summary["scalein_within_target"] = (
        by["scalein"]["migrated_requests"] >= 1
        and summary["scalein_itl_ratio_nonmigrated"] <= ITL_RATIO_TARGET)
    summary["all_gates"] = (
        summary["migrate_zero_loss"]
        and summary["migrate_token_identical"]
        and by["migrate"]["migrations_completed"] >= 1
        and summary["stall_within_bound"]
        and summary["scalein_within_target"])
    rows.append(summary)
    log(json.dumps(summary))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--slo-max-load", type=int, default=16)
    ap.add_argument("--arrive-every", type=int, default=2)
    ap.add_argument("--migrate-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="qwen3-0.6b's smoke widths (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    run = make_run_config("qwen3-0.6b", "decode_32k", smoke=args.smoke)
    params = build_model(run).init(seed=0, device=device)
    rows = bench(run, params, device, ticks=args.ticks,
                 max_new=args.max_new, slots=args.slots,
                 slo_max_load=args.slo_max_load,
                 arrive_every=args.arrive_every,
                 migrate_every=args.migrate_every, seed=args.seed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if rows[-1]["all_gates"] else 1


if __name__ == "__main__":
    sys.exit(main())
