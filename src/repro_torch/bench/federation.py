"""Lease-routed multi-host fleet at scale on the port — exactly-once
admission under network faults, deterministic token streams without them
(mirrors ``benchmarks/federation.py``: the same protocol, gates, report
keys and counter-hashed token streams, so the fleet digests equal the JAX
benchmark's at the same arguments).

The claims under test:

  1. exactly-once serving (I15) — across every run, including the
     partition run, no request id ever receives a token from more than
     one host (dual-serve ledger stays empty), and no completed request
     id appears in more than one engine's completion table;
  2. determinism — two full runs at ``partition_rate=0`` with the same
     seed produce BIT-IDENTICAL fleet token digests (crc32 over the
     sorted ``(rid, token stream)`` completion set);
  3. completion — every request the coordinator successfully admitted
     (including admissions whose ack was lost and later confirmed by
     ``reconcile``) completes exactly once; nothing is lost, nothing is
     re-served;
  4. scale — the committed artifact covers >= 8 hosts x 256 lite
     engines each and >= 1e5 simulated requests, with throughput
     (admissions/s, tokens/s) reported as context.

Protocol: three runs on a fleet of ``Host``s whose serve plane is
``LiteEngine``s — dict-backed engines exposing exactly the duck-typed
surface ``Host.submit``/``serve_targets`` route on (``submit_request``,
``queue``, ``active``, ``SLOTS``, ``owns_request``), with counter-hashed
token streams that depend only on ``(rid, run seed)`` —

  base      partition_rate=0: the full request count, drained to empty
  rerun     the SAME config again; its digest must equal base's
  faults    partition_rate>0: armed ack-loss windows (admit lands, ack
            dies -> in-doubt -> heal -> ``reconcile`` confirms), random
            coordinator<->host partitions long enough to lapse leases,
            and one mid-run coordinator ``handoff`` (epoch fence)

All time is a ``VirtualClock``; one tick = one synchronized decode step
across every engine on every host (partitioned hosts keep stepping —
the partition cuts the control plane, not host-local progress).

The engines are dict-backed and hold no tensor, as in the JAX benchmark:
this driver measures the control plane (``Host`` / ``FederationCoordinator``
routing, leases, fences, reconciliation), which runs on the host. It
therefore takes no ``--device``; that is not a CPU fallback of a card
path, there is no card path. Its admits/s and tokens/s are host rates.

Acceptance gates (the JAX package's committed BENCH_federation.json):
  * dual-serve violations == 0 over ALL runs (ledger + completion-table
    uniqueness);
  * base digest == rerun digest (bit-identity at partition_rate=0);
  * every run: completed rid set == admitted rid set, 0 lost;
  * faults run: >= 1 in-doubt admission confirmed, >= 1 partition,
    epoch advanced past the handoff.
``--reduced`` runs a small fleet with the same gates minus the scale
floor, which only the full-size run must meet.

    python -m repro_torch.bench.federation --reduced
    python -m repro_torch.bench.federation --out fed.json    # 8 x 256
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import time
import zlib

from repro_torch.core import (AdmissionError, FederationCoordinator, Host,
                              HostUnreachableError)
from repro_torch.sim.clock import VirtualClock

VOCAB = 257
TICK_S = 0.5             # virtual seconds per fleet step
PARTITION_TICKS = 8      # long enough to lapse a 3.0 s lease at TICK_S


class DualServeLedger:
    """I15 witness: the first host to emit a token for a rid owns it
    forever; any token from a different host is a violation."""

    def __init__(self):
        self.owner = {}
        self.violations = []

    def record(self, rid, host_id):
        prev = self.owner.setdefault(rid, host_id)
        if prev != host_id:
            self.violations.append(
                {"rid": rid, "first": prev, "second": host_id})


class LiteEngine:
    """Minimal routable engine: the duck-typed serve surface ``Host``
    consumes, nothing else. Token streams are counter hashes of
    ``(rid, position, seed)`` so they depend only on the request, never
    on placement — bit-identity across runs is a property of routing
    determinism, which is exactly what the bench measures."""

    SLOTS = 4

    def __init__(self, tid, host_id, ledger):
        self.tid = tid
        self.host_id = host_id
        self.ledger = ledger
        self.queue = []
        self.active = [None] * self.SLOTS
        self.done = {}           # rid -> tuple(token stream)

    def submit_request(self, rid, seed=None):
        seed = 0 if seed is None else seed
        req = {"rid": rid, "seed": seed, "tokens": [],
               "max_new": 1 + zlib.crc32(b"%d:%d" % (rid, seed)) % 4}
        self.queue.append(req)
        return req

    def owns_request(self, rid):
        return (any(r is not None and r["rid"] == rid for r in self.active)
                or any(r["rid"] == rid for r in self.queue))

    def step(self):
        emitted = 0
        for i in range(self.SLOTS):
            if self.active[i] is None and self.queue:
                self.active[i] = self.queue.pop(0)
        for i, r in enumerate(self.active):
            if r is None:
                continue
            tok = zlib.crc32(b"%d:%d:%d" % (r["rid"], len(r["tokens"]),
                                            r["seed"])) % VOCAB
            r["tokens"].append(tok)
            self.ledger.record(r["rid"], self.host_id)
            emitted += 1
            if len(r["tokens"]) >= r["max_new"]:
                self.done[r["rid"]] = tuple(r["tokens"])
                self.active[i] = None
        return emitted


def make_fleet(workdir, *, hosts, engines_per_host, policy, ledger):
    clock = VirtualClock()
    fleet = []
    for h in range(hosts):
        hid = f"h{h}"
        host = Host(hid, workdir=os.path.join(workdir, hid), clock=clock,
                    num_devices=2, max_vfs=2, policy=policy,
                    max_load_per_engine=LiteEngine.SLOTS + 2)
        for e in range(engines_per_host):
            tid = f"{hid}.e{e:04d}"
            host.engines[tid] = LiteEngine(tid, hid, ledger)
        fleet.append(host)
    co = FederationCoordinator(fleet, clock=clock, policy=policy)
    co.heartbeat_all()
    return clock, fleet, co


def fleet_digest(fleet):
    """crc32 over the sorted (rid, token stream) completion set — the
    bit-identity witness. Also returns the completed rid list and the
    count of rids completed by more than one engine (must be 0)."""
    rows, dup = [], 0
    seen = set()
    for host in fleet:
        for eng in host.engines.values():
            for rid, toks in eng.done.items():
                if rid in seen:
                    dup += 1
                seen.add(rid)
                rows.append((rid, toks))
    rows.sort()
    d = 0
    for rid, toks in rows:
        d = zlib.crc32(repr((rid, toks)).encode(), d)
    return d, seen, dup


def run_once(label, *, hosts, engines_per_host, requests, policy, seed,
             partition_rate, handoff_at=None):
    """Drive one federation run to full drain; returns the report row."""
    ledger = DualServeLedger()
    workdir = tempfile.mkdtemp(prefix="svff_bench_fed_")
    t0 = time.perf_counter()
    try:
        clock, fleet, co = make_fleet(
            workdir, hosts=hosts, engines_per_host=engines_per_host,
            policy=policy, ledger=ledger)
        rng = random.Random(seed)
        rate = hosts * engines_per_host * LiteEngine.SLOTS // 3
        admitted, in_doubt_confirmed, lost = set(), 0, 0
        tokens = ticks = reroute_ticks = 0
        part_until, partitions = -1, 0
        # a fault run always exercises BOTH catalogued shapes at fixed
        # ticks (ack loss, lease-lapsing partition); the random rate
        # rides on top — keeps the gates deterministic per seed
        forced = {2: "ack", 6: "part"} if partition_rate > 0 else {}
        while len(admitted) < requests or any(
                h.load() for h in fleet):
            ticks += 1
            if ticks == part_until:
                co.fabric.heal()
                co.heartbeat_all()
                rec = co.reconcile()
                in_doubt_confirmed += len(rec["confirmed"])
                lost += len(rec["lost"])
            co.heartbeat_all()
            if (handoff_at is not None and len(admitted) >= handoff_at
                    and co.epoch == 1):
                co = co.handoff()
            fault = None
            if not co.fabric.partitioned and partition_rate > 0:
                if ticks in forced:
                    fault = forced.pop(ticks)
                elif rng.random() < partition_rate:
                    fault = "ack" if rng.random() < 0.5 else "part"
            if fault == "ack":
                # ack loss: the NEXT admission lands, its ack dies
                co.fabric.arm("fed_submit_after_admit", [co.node_id])
            elif fault == "part":
                # hard partition: one host drops off the control plane
                # long enough for its lease to lapse
                victim = f"h{rng.randrange(hosts)}"
                co.fabric.partition(
                    [n for n in [co.node_id] + sorted(co.hosts)
                     if n != victim])
                partitions += 1
                part_until = ticks + PARTITION_TICKS
            for _ in range(rate):
                if len(admitted) >= requests:
                    break
                try:
                    res = co.submit(seed=seed)
                except (AdmissionError, HostUnreachableError):
                    reroute_ticks += 1
                    break          # fleet full or cut off: drain a tick
                admitted.add(res["rid"])
                if res["in_doubt"]:
                    co.fabric.heal()
                    co.heartbeat_all()
                    rec = co.reconcile()
                    in_doubt_confirmed += len(rec["confirmed"])
                    lost += len(rec["lost"])
            for host in fleet:
                for eng in host.engines.values():
                    tokens += eng.step()
            clock.advance(TICK_S)
        digest, completed, dup = fleet_digest(fleet)
        wall = time.perf_counter() - t0
        return {
            "run": label, "hosts": hosts,
            "engines": hosts * engines_per_host,
            "policy": policy, "seed": seed,
            "partition_rate": partition_rate,
            "requests": requests,
            "admitted": len(admitted), "completed": len(completed),
            "complete_ok": completed == admitted and lost == 0,
            "dual_serve_violations": len(ledger.violations) + dup,
            "tokens": tokens, "ticks": ticks,
            "digest": digest,
            "in_doubt_confirmed": in_doubt_confirmed, "lost": lost,
            "partitions": partitions, "fabric_partitions": co.fabric.partitions,
            "epoch": co.epoch,
            "coordinator_rejections": co.rejections,
            "reroute_ticks": reroute_ticks,
            "wall_s": round(wall, 3),
            "admits_per_s": round(len(admitted) / wall, 1),
            "tokens_per_s": round(tokens / wall, 1),
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def bench(*, hosts, engines_per_host, requests, policy, seed,
          partition_rate, reduced):
    rows = []
    base = run_once("base", hosts=hosts, engines_per_host=engines_per_host,
                    requests=requests, policy=policy, seed=seed,
                    partition_rate=0.0)
    rows.append(base)
    print(json.dumps(base), flush=True)
    rerun = run_once("rerun", hosts=hosts,
                     engines_per_host=engines_per_host,
                     requests=requests, policy=policy, seed=seed,
                     partition_rate=0.0)
    rows.append(rerun)
    print(json.dumps(rerun), flush=True)
    fault_requests = max(requests // 6, 2000)
    faults = run_once("faults", hosts=hosts,
                      engines_per_host=engines_per_host,
                      requests=fault_requests, policy=policy, seed=seed,
                      partition_rate=partition_rate,
                      handoff_at=fault_requests // 2)
    rows.append(faults)
    print(json.dumps(faults), flush=True)

    gates = {
        "dual_serve_zero": all(r["dual_serve_violations"] == 0
                               for r in rows),
        "digest_identical": base["digest"] == rerun["digest"],
        "complete_exactly_once": all(r["complete_ok"] for r in rows),
        "faults_exercised": (faults["in_doubt_confirmed"] >= 1
                             and faults["partitions"] >= 1
                             and faults["epoch"] >= 2),
    }
    scale = {"hosts_ok": hosts >= 8,
             "requests_ok": base["requests"] >= 100_000}
    summary = {
        "run": "summary", "reduced": reduced,
        "gates": gates, "scale": scale,
        "all_gates": all(gates.values()) and (
            reduced or all(scale.values())),
    }
    rows.append(summary)
    print(json.dumps(summary), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hosts", type=int, default=8)
    ap.add_argument("--engines-per-host", type=int, default=256)
    ap.add_argument("--requests", type=int, default=120_000)
    ap.add_argument("--policy", default="fair_share")
    ap.add_argument("--partition-rate", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="a small fleet: 3 hosts x 16 engines, 3k "
                         "requests, same gates minus the scale floor")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.reduced:
        args.hosts = min(args.hosts, 3)
        args.engines_per_host = min(args.engines_per_host, 16)
        args.requests = min(args.requests, 3_000)
    rows = bench(hosts=args.hosts, engines_per_host=args.engines_per_host,
                 requests=args.requests, policy=args.policy,
                 seed=args.seed, partition_rate=args.partition_rate,
                 reduced=args.reduced)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    return 0 if rows[-1]["all_gates"] else 1


if __name__ == "__main__":
    sys.exit(main())
