"""Invariant checker — asserted after EVERY op of every scenario (mirrors
``repro.sim.invariants``).

Ported: I1-I5, I8, I10, I12, I13 and I14 (``check_invariants``), I6
(``check_timings``), I7 (``check_pause_timings``) and I11
(``check_autoscale``); I9 lives in
``repro_torch.sim.chaos.recover_manager``. Not ported yet:
``check_federation`` (I15, with I16, ROADMAP Queue 1 item 9). I4 reads
each device leaf to the host once and compares it with
``expected_state`` bit for bit; I12 reads a serving tenant's block table
to the host once.

  I1  exclusive ownership: a tenant owns at most one VF, a VF at most one
      tenant, and device sets of device-holding VFs are pairwise disjoint
      and within-pool (IOMMU isolation; delegates to the pool's own check)
  I2  state-machine coherence: running tenant <-> ATTACHED VF with
      devices; paused tenant <-> PAUSED VF holding NO devices, owner kept
  I3  pause durability: every paused tenant has a config-space snapshot
      in host RAM whose step counter matches the tenant's, and the
      snapshot set contains EXACTLY the paused tenants
  I4  bit-identity: a running SimTenant's state equals
      ``expected_state(seed, steps_done)`` bit-for-bit — any corruption
      across pause/unpause/migrate/detach round-trips shows here
  I5  records <-> pool: the on-disk attach records are exactly the
      attached-or-paused tenants, and each record names the tenant's VF;
      detached tenants have a disk snapshot to re-attach from
  I6  Table-II timing dicts are well-formed: exactly the paper's four
      macro steps + total, all finite and non-negative, total = sum
  I7  pause stall accounting (``check_pause_timings``): every pause's
      PhaseTimings contains the three stop-and-copy steps, tenant-visible
      ``stop_s`` <= ``total``, only ``precopy_*`` phases may be
      background, and a live pause must have run background pre-copy —
      i.e. the reported stall is never under- or over-stated
  I8  journal/pool/records mutual consistency: at every quiescent point
      the WAL has no pending entries and no torn ``*.part`` files exist
      (records or journal dir), and replaying the committed entries in
      order predicts exactly each journaled tenant's live status — i.e.
      no committed intent contradicts the world, and no effect exists
      without a committed intent
  I9  recovery idempotence (checked by the chaos harness, not here):
      ``SVFFManager.recover`` applied twice equals once, bit-identically
      (``repro_torch.sim.chaos.recover_manager``), and recovered tenants still
      satisfy I4
  I10 serve-token determinism: every request a serving tenant has emitted
      tokens for — finished or in flight — matches the no-reconfiguration
      oracle (``SimServeTenant.expected_output``) token-for-token. A
      request's output is identical with and without a pause/pause_live/
      migrate mid-flight; any byte corrupted in the paged KV state by a
      reconfiguration round-trip surfaces here as token divergence
  I11 autoscale justification (``check_autoscale``, run by the harness
      after every autoscale op): every action the autoscaler took must be
      justified by the telemetry snapshot it read — scale_out only with a
      hot engine AND spare capacity, scale_in only of an idle victim
      above the floor, rebalance only across a real hot/cold gap with
      queued work to move. Paired with I10 (checked after the same op),
      this is the claim that the control plane never reconfigures without
      telemetry evidence and never perturbs a token stream doing so
  I12 page-refcount accounting: for every tenant holding a
      ``BlockAllocator``, refcounts recomputed from the per-rid page
      chains equal the allocator's live refcount map (its own
      ``check_invariants`` — free/owned partition, trie registration
      agreement), AND every active slot's block-table row spells out
      exactly its request's allocator chain. An over-decref (double
      free) frees a page a prefix-sharing sibling still reads through;
      a CoW that repoints the chain but not the table row (or vice
      versa) makes reads and ownership disagree — both surface here
  I13 request-migration liveness: across all serve-shaped tenants, every
      request is LIVE (queued, active, or prefilling) on at most one
      engine, every rid that owns allocator pages corresponds to a
      request live on that same engine, and the same rid never owns
      pages in two allocators — i.e. the source's pages are freed iff
      the target committed, and an aborted/crashed migration never
      leaves a request duplicated, stranded, or page-orphaned. A slot
      frozen by an in-flight migration counts as live on the SOURCE
      (extraction copies, never moves). I10 extends across migration:
      a migrated request's token stream still equals its no-migration
      oracle, because extraction ships the exact page bytes plus
      pos/last_token and sampling is counter-seeded
  I14 gang/template coherence: every RUNNING pipeline gang lead runs at
      a width it has a registered stage template for, exactly width-1 of
      its shell members are running (one VF per stage, so with the
      lead's own VF the gang spans exactly ``width`` VFs), and the
      active template's stage bounds strictly partition periods
      0..num_periods into width non-empty stages — i.e. a live engine's
      VF set always matches exactly one registered template and its
      stage-resident state partitions cleanly. A crashed gang op
      (attach_group / reshape) must recover to a state satisfying this,
      so a half-attached gang or a half-applied width change is a
      violation, not a transient

Violations raise ``InvariantViolation`` tagged by the caller with the
scenario seed and op index, which is all that is needed to reproduce.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from repro_torch.core.journal import COMPLETED_STATUS
from repro_torch.core.vf import VFState
from repro_torch.tree import flatten

TIMING_KEYS = frozenset({"rescan", "remove_vf", "change_num_vf", "add_vf",
                         "total"})


class InvariantViolation(AssertionError):
    pass


def _fail(msg: str):
    raise InvariantViolation(msg)


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array (one read of a device tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_invariants(mgr) -> None:
    pool = mgr.pool

    # -- I1: exclusive ownership / device disjointness -----------------------
    try:
        pool._check_invariants()
    except Exception as e:
        _fail(f"I1 pool isolation: {e}")
    owner_of = {}
    for vf in pool.vfs.values():
        if vf.owner is not None:
            if vf.owner in owner_of:
                _fail(f"I1 tenant {vf.owner} owns both "
                      f"{owner_of[vf.owner]} and {vf.vf_id}")
            owner_of[vf.owner] = vf.vf_id

    # -- I2: tenant status <-> VF state --------------------------------------
    for tid, tn in mgr.tenants.items():
        if tn.status == "running":
            if tn.vf_id is None or tn.vf_id not in pool.vfs:
                _fail(f"I2 running {tid} has no VF ({tn.vf_id})")
            vf = pool.vfs[tn.vf_id]
            if vf.state != VFState.ATTACHED or vf.owner != tid:
                _fail(f"I2 running {tid}: VF {vf.vf_id} is "
                      f"{vf.state.value}/owner={vf.owner}")
            if not vf.devices:
                _fail(f"I2 running {tid}: VF {vf.vf_id} holds no devices")
        elif tn.status == "paused":
            vf = pool.vfs.get(tn.vf_id)
            if vf is None:
                _fail(f"I2 paused {tid}: VF {tn.vf_id} vanished")
            if vf.state != VFState.PAUSED or vf.owner != tid:
                _fail(f"I2 paused {tid}: VF {vf.vf_id} is "
                      f"{vf.state.value}/owner={vf.owner}")
            if vf.devices:
                _fail(f"I2 paused {tid}: VF {vf.vf_id} still holds "
                      f"{len(vf.devices)} devices")
        elif tn.status == "detached":
            if tn.vf_id is not None:
                _fail(f"I2 detached {tid} still points at {tn.vf_id}")

    # -- I3: snapshots == paused tenants, counters preserved -----------------
    paused_ids = {tid for tid, tn in mgr.tenants.items()
                  if tn.status == "paused"}
    snap_ids = set(mgr.snapshots)
    if snap_ids != paused_ids:
        _fail(f"I3 snapshots {sorted(snap_ids)} != paused "
              f"{sorted(paused_ids)}")
    for tid in paused_ids:
        snap = mgr.snapshots[tid]
        if snap.steps_done != mgr.tenants[tid].steps_done:
            _fail(f"I3 {tid}: snapshot step {snap.steps_done} != tenant "
                  f"step {mgr.tenants[tid].steps_done}")
        if snap.tenant_id != tid:
            _fail(f"I3 snapshot for {tid} names {snap.tenant_id}")

    # -- I4: bit-identical state (SimTenant only) -----------------------------
    for tid, tn in mgr.tenants.items():
        if tn.status != "running" or not hasattr(tn, "expected_now"):
            continue
        want = tn.expected_now()
        got = tn.export_state()
        # leaves in sorted-key order, as JAX's (a restore rebuilds a
        # tree in that order)
        wl = [x for _, x in flatten(want)[0]]
        gl = [x for _, x in flatten(got)[0]]
        if len(wl) != len(gl):
            _fail(f"I4 {tid}: state tree shape changed")
        for i, (w, g) in enumerate(zip(wl, gl)):
            if not np.array_equal(w, _host(g)):
                _fail(f"I4 {tid}: leaf {i} not bit-identical after "
                      f"{tn.steps_done} steps")

    # -- I5: records on disk match pool state ---------------------------------
    attached_ids = {tid for tid, tn in mgr.tenants.items()
                    if tn.status in ("running", "paused")}
    rec_ids = set(mgr.records.list())
    if rec_ids != attached_ids:
        _fail(f"I5 records {sorted(rec_ids)} != attached "
              f"{sorted(attached_ids)}")
    for tid in attached_ids:
        rec = mgr.records.read(tid)
        if rec["tenant"] != tid:
            _fail(f"I5 record file {tid} names {rec['tenant']}")
        if rec["vf"]["vf_id"] != mgr.tenants[tid].vf_id:
            _fail(f"I5 {tid}: record VF {rec['vf']['vf_id']} != live "
                  f"{mgr.tenants[tid].vf_id}")
    parked = set(mgr._detached_steps())
    for tid, tn in mgr.tenants.items():
        if tn.status == "detached" and tid not in parked:
            _fail(f"I5 detached {tid} has no disk snapshot to re-attach")

    # -- I8: journal <-> pool <-> records mutual consistency ------------------
    journal = getattr(mgr, "journal", None)
    if journal is not None:
        pending = [e for e in journal.iter_entries()
                   if e["status"] == "pending"]
        if pending:
            _fail(f"I8 journal has pending intents at a quiescent point: "
                  f"{[(e['seq'], e['op'], e['tenant']) for e in pending]}")
        parts = mgr.records.part_files()
        if parts:
            _fail(f"I8 orphaned record .part files: {parts}")
        jparts = [f for f in os.listdir(journal.dir) if f.endswith(".part")]
        if jparts:
            _fail(f"I8 orphaned journal .part files: {jparts}")
        # replay: the committed history must predict every journaled
        # tenant's live status (status transitions happen ONLY via
        # journaled ops, so history and world may never disagree)
        expect: dict = {}
        for e in journal.iter_entries():           # read-only, no copies
            if e["status"] != "committed":
                continue
            if e["op"] not in COMPLETED_STATUS:
                _fail(f"I8 committed entry {e['seq']} has unknown op "
                      f"{e['op']!r}")
            expect[e["tenant"]] = COMPLETED_STATUS[e["op"]]
        for tid, want in expect.items():
            tn = mgr.tenants.get(tid)
            if tn is None:
                _fail(f"I8 journal committed ops for unknown tenant {tid}")
            if tn.status != want:
                _fail(f"I8 {tid}: journal history says {want!r}, live "
                      f"status is {tn.status!r}")

    # -- I10: serve-token determinism across reconfigurations -----------------
    for tid, tn in mgr.tenants.items():
        if not hasattr(tn, "expected_output"):
            continue
        for req in getattr(tn, "requests", ()):
            # the oracle replays from the seed the request was MINTED
            # under — a rebalance may have handed it to another tenant
            want = tn.expected_output(getattr(req, "seed", tn.seed),
                                      req.rid)
            got = list(req.out)
            if req.done and got != want:
                _fail(f"I10 {tid} rid={req.rid}: finished output {got} "
                      f"!= oracle {want} (token divergence across a "
                      f"reconfiguration)")
            if not req.done and got != want[:len(got)]:
                _fail(f"I10 {tid} rid={req.rid}: in-flight prefix {got} "
                      f"diverged from oracle {want[:len(got)]}")
            if req.done and not req.out:
                _fail(f"I10 {tid} rid={req.rid}: done with no tokens")

    # -- I12: page refcounts == live block-table references --------------------
    for tid, tn in mgr.tenants.items():
        host = tn if hasattr(tn, "alloc") else getattr(tn, "engine", None)
        alloc = getattr(host, "alloc", None)
        if alloc is None:
            continue
        # the allocator's own books first: refcounts recomputed from the
        # per-rid chains must equal the live _ref map (an over-decref
        # frees a page a sibling still reads through)
        try:
            alloc.check_invariants()
        except AssertionError as e:
            _fail(f"I12 {tid}: allocator accounting: {e}")
        # then the device view: every active slot's table row must spell
        # out exactly its request's allocator chain (a CoW that repointed
        # the chain but not the table — or vice versa — diverges here)
        tables = getattr(host, "tables", None)
        if tables is not None:
            tables = _host(tables)
            for s, req in enumerate(getattr(host, "active", ())):
                if req is None:
                    continue
                chain = alloc.pages_of(req.rid)
                row = [int(x) for x in tables[s][:len(chain)]]
                if row != chain:
                    _fail(f"I12 {tid} slot {s}: table row {row} != "
                          f"allocator chain {chain} for rid {req.rid}")

    # -- I13: request-migration liveness ---------------------------------------
    # Every request is live on at most ONE engine, and page ownership
    # follows liveness: a rid owning allocator pages must be live (active,
    # prefilling, or mid-migration-frozen — all of which keep the request
    # in ``active``/``_jobs``) on that same engine. Together these say a
    # migration frees the source's pages iff the target committed, and
    # never duplicates or strands a request.
    live_on: dict = {}                         # rid -> hosting tid
    for tid, tn in mgr.tenants.items():
        host = tn if hasattr(tn, "alloc") else getattr(tn, "engine", None)
        if host is None or not hasattr(host, "active"):
            continue
        live_here = ([r for r in getattr(host, "queue", ()) ]
                     + [r for r in host.active if r is not None]
                     + [j.req for j in getattr(host, "_jobs", {}).values()])
        seen_here: set = set()
        for req in live_here:
            rid = req.rid
            if rid in seen_here:
                _fail(f"I13 {tid}: request {rid} appears twice on one "
                      f"engine (queue/slots/jobs)")
            seen_here.add(rid)
            if rid in live_on:
                _fail(f"I13 request {rid} live on BOTH {live_on[rid]} "
                      f"and {tid} (migration duplicated it)")
            live_on[rid] = tid
        alloc = getattr(host, "alloc", None)
        if alloc is None:
            continue
        for rid in alloc.owners():
            if rid not in seen_here:
                _fail(f"I13 {tid}: allocator pages owned by rid {rid} "
                      f"with no live request on this engine (source "
                      f"pages not freed after a committed migration, or "
                      f"a leaked admission)")

    # -- I14: gang/template coherence ------------------------------------------
    # A pipeline gang lead that is RUNNING must be at a registered
    # template width, with exactly width-1 running shells (one VF per
    # stage counting the lead's own) and stage bounds that strictly
    # partition its periods. Checked only at quiescent points, so a
    # crashed gang op that recovers half-attached shows up here.
    for tid, tn in mgr.tenants.items():
        shells = getattr(tn, "gang_shells", None)
        if not shells or getattr(tn, "status", None) != "running":
            continue
        k = getattr(tn, "stage_width", 1)
        if not tn.has_template(k):
            _fail(f"I14 {tid}: live at width {k} with no registered "
                  f"stage template")
        live = [sh.tid for sh in shells
                if getattr(sh, "status", None) == "running"]
        if len(live) != k - 1:
            _fail(f"I14 {tid}: width {k} but {len(live)} running "
                  f"shells {live} (want exactly {k - 1})")
        bounds = tuple(tn.stage_bounds())
        nper = getattr(tn, "num_periods", None)
        if (len(bounds) != k + 1 or bounds[0] != 0
                or bounds[-1] != nper
                or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:]))):
            _fail(f"I14 {tid}: stage bounds {bounds} do not partition "
                  f"{nper} periods into {k} non-empty stages")


def check_timings(timings: dict) -> None:
    """I6 — a reconf's Table-II dict is well-formed."""
    if set(timings) != TIMING_KEYS:
        _fail(f"I6 timing keys {sorted(timings)} != "
              f"{sorted(TIMING_KEYS)}")
    for k, v in timings.items():
        if not isinstance(v, float) or not math.isfinite(v) or v < 0:
            _fail(f"I6 timing {k}={v!r} not a finite non-negative float")
    body = sum(v for k, v in timings.items() if k != "total")
    if abs(body - timings["total"]) > 1e-6:
        _fail(f"I6 total {timings['total']} != sum of steps {body}")


#: the tenant-visible phases every pause's stop-and-copy must contain
PAUSE_STOP_PHASES = frozenset({"save_config_space", "unregister_pci",
                               "unregister_vfio"})


def check_pause_timings(t, live: bool = False) -> None:
    """I7 — a pause's ``PhaseTimings`` is well-formed and its stall is
    bounded: the tenant-visible ``stop_s`` never exceeds ``total``, only
    pre-copy rounds may run in the background, and a live pause accounts
    its rounds as background (so stop-and-copy is the ONLY stall)."""
    for k, v in t.phases.items():
        if not isinstance(v, float) or not math.isfinite(v) or v < 0:
            _fail(f"I7 pause phase {k}={v!r} not finite/non-negative")
    if not PAUSE_STOP_PHASES <= set(t.phases):
        _fail(f"I7 pause phases {sorted(t.phases)} missing stop-and-copy "
              f"steps {sorted(PAUSE_STOP_PHASES)}")
    if t.stop_s > t.total + 1e-9:
        _fail(f"I7 stop_s {t.stop_s} exceeds total {t.total}")
    for name in t.background:
        if not name.startswith("precopy_"):
            _fail(f"I7 non-precopy phase {name!r} marked background "
                  f"(stall under-reported)")
    if t.background & PAUSE_STOP_PHASES:
        _fail(f"I7 stop-and-copy phase marked background: {t.background}")
    if live:
        if not t.background:
            _fail("I7 live pause ran no background pre-copy rounds")
        precopy = {k for k in t.phases if k.startswith("precopy_")}
        if precopy != t.background:
            # a precopy phase recorded with stop=True would inflate the
            # reported stall; a stop phase in background would hide it
            _fail(f"I7 background {sorted(t.background)} != recorded "
                  f"pre-copy rounds {sorted(precopy)}")
    elif t.background:
        _fail(f"I7 stop-the-world pause has background phases "
              f"{sorted(t.background)}")


def check_autoscale(action, cfg) -> None:
    """I11 — an autoscaler action must be justified by the telemetry
    snapshot it carries (``core.autoscaler.justify_action`` re-derives
    the action's necessary conditions from that snapshot alone). The
    token-stream half of the invariant — the action must not perturb any
    request's output — is I10, which the harness checks after the same
    op."""
    from repro_torch.core.autoscaler import justify_action
    err = justify_action(action, cfg)
    if err is not None:
        _fail(f"I11 unjustified autoscale action "
              f"(snapshot {action.snapshot.describe()}): {err}")
