"""Scenario DSL + seeded generator (a copy of ``repro.sim.scenario``).

A *scenario* is a deterministic sequence of ``Op``s derived entirely from
``ScenarioConfig.seed`` — ``generate_scenario(cfg)`` called twice returns
identical tuples, so any failing run is reproducible from its seed alone
(see the ``repro_torch.sim`` package docstring). The generator is pure
``random`` code and emits the JAX package's op tuple exactly, for every
seed and config, the ``autoscale``, ``migrate_request`` and ``reshape``
ops included. This module is SINGLE-host: one manager, one op stream
(the multi-host plane is ``sim.federation``).

Op kinds (the paper's management surface + fault injection):

  init     first op always: create the pool, partition into VFs, attach
           the initial tenants
  attach   bind a (new or previously detached) tenant via the scheduler
  detach   standard SR-IOV detach (state parked on disk)
  pause    SVFF pause (state staged to host RAM, devices released)
  pause_live  pre-copy live pause: the tenant keeps stepping through
           background snapshot rounds, then a short stop-and-copy; the
           harness checks the stall accounting (invariant I7) and the
           usual bit-identity on unpause (I4)
  unpause  restore a paused tenant onto its VF
  reconf   full reconfiguration cycle (grow or shrink #VF) — returns the
           Table-II timing dict the invariant checker validates
  migrate  pause -> reallocate -> unpause (straggler mitigation)
  fault    inject a device failure, then run a Supervisor round that must
           recover the tenant via migration (core/fault.py)
  step     the tenant's own workload advances N steps
  crash    kill the manager at a named crash point while it runs a
           trigger op (``repro_torch.sim.chaos.CRASH_POINTS``), then rebuild it
           with ``SVFFManager.recover`` — the harness checks invariants
           I1-I8 plus recovery idempotence (I9) afterwards
  serve_submit  a burst of requests arrives at the serving tenant sv0
           (guest-side queueing: legal even while sv0 is paused)
  serve_step    the serving engines advance N iterations (admit + batched
           decode over paged KV); invariant I10 then checks every
           request's tokens against the no-reconfiguration oracle
  autoscale  one elastic-control-plane epoch: the harness snapshots the
           serving tenants' telemetry, runs the ``core.autoscaler``
           policy loop, and executes the planned action (attach a new
           serving tenant / detach an idle one / move queued requests
           hot->cold + migrate) through the journaled manager ops;
           invariant I11 then checks the action against the snapshot
  reshape  re-instantiate the pipeline gang lead pg0 at a new stage
           width K' through the journaled ``SVFFManager.reshape`` gang
           op (attach/detach the shell members, apply the registered
           template); invariant I14 then checks the gang's VF set
           matches the template and I10 that in-flight token streams
           crossed the width change bit-identically
  migrate_request  live-migrate one in-flight request between running
           serving engines through the journaled manager op: extract
           its KV block chain on the source, ship it through the
           staging pipeline, admit it on the target, free the source
           pages; invariant I13 then checks single ownership and I10
           that the request's token stream is unchanged (a
           CacheExhausted abort on the target is a legal, clean no-op)

The generator keeps a conservative validity model (who is running/paused/
detached, how many VFs exist) so sequences are mostly executable, and —
at ``chaos_rate`` — deliberately emits invalid ops (attach with no free
VF, detach of a paused VF, double pause, ...) to exercise the manager's
rejection atomicity: a rejected op must leave every invariant intact.
``crash_rate`` (default 0, so pre-chaos scenarios are byte-identical)
additionally emits crash ops; since every crash point has a cataloged
deterministic recovery outcome (rolled back or rolled forward), the
model tracks post-recovery state exactly and later ops stay valid.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

OP_KINDS = ("init", "attach", "detach", "pause", "pause_live", "unpause",
            "reconf", "migrate", "fault", "step", "crash",
            "serve_submit", "serve_step", "autoscale", "migrate_request",
            "reshape")

#: arrival-pattern shapes for serve_submit bursts ("bursty" is the
#: original mix and the default; the others model the traffic traces the
#: elastic control plane is benchmarked on)
ARRIVAL_PATTERNS = ("bursty", "ramp", "spike", "diurnal")


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str
    tenant: Optional[str] = None
    num_vfs: Optional[int] = None
    devices_per_vf: Optional[int] = None
    num_tenants: Optional[int] = None      # init only
    steps: int = 1
    chaos: bool = False                     # expected to be rejected
    point: Optional[str] = None             # crash only: crash point name
    trigger: Optional[str] = None           # crash only: op that reaches it
    burst: int = 0                          # serve_submit only: #requests

    def __post_init__(self):
        assert self.kind in OP_KINDS, self.kind


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    seed: int = 0
    num_ops: int = 24
    num_devices: int = 16
    max_vfs: int = 6
    max_tenants: int = 5
    policy: str = "first_fit"
    leaf_size: int = 16
    chaos_rate: float = 0.08
    crash_rate: float = 0.0
    # serve-traffic ops (0 keeps pre-serve sequences byte-identical): at
    # this rate the scenario interleaves serve_submit (bursty arrivals) /
    # serve_step ops on a dedicated serving tenant "sv0" that is attached
    # right after init and participates in pause/pause_live/unpause/
    # migrate like any other tenant — invariant I10 checks its tokens
    serve_rate: float = 0.0
    # elastic control plane (0 keeps pre-autoscale sequences byte-
    # identical): at this rate — only meaningful with serve_rate > 0 —
    # the scenario emits ``autoscale`` ops; the harness runs one policy-
    # loop epoch per op and I11 checks every action it takes
    autoscale_rate: float = 0.0
    # request live migration (0 keeps earlier sequences byte-identical):
    # at this rate — only meaningful with serve_rate > 0 — the scenario
    # attaches a second serving engine "sv1" at init and emits
    # ``migrate_request`` ops; the harness deterministically picks a
    # (src, dst) pair among the running serving engines and runs the
    # journaled ``SVFFManager.migrate_request`` op (no migratable
    # request / no pair is a no-op; CacheExhausted is a clean abort)
    migrate_rate: float = 0.0
    # elastic pipeline gang (0 keeps earlier sequences byte-identical):
    # at this rate the scenario attaches a pipeline gang lead "pg0" at
    # width K=2 right after init (via the journaled attach_group) and
    # emits ``reshape`` ops that alternate its width 2<->3, interleaved
    # with serve traffic on pg0 so width changes cross in-flight token
    # streams; invariant I14 checks gang/template coherence after every
    # op. Enabled only when the VF/device budget can hold the trainers,
    # the sv engines AND the gang at max width (3 VFs)
    reshape_rate: float = 0.0
    # serve_submit burst shape (see ARRIVAL_PATTERNS): "bursty" (default,
    # the original draw), "ramp" (bursts grow across the scenario),
    # "spike" (mostly quiet with rare large bursts), "diurnal" (sinusoid)
    arrival: str = "bursty"


# weights for the op mix after init (step dominates: tenants mostly work)
_WEIGHTS = (("step", 30), ("pause", 6), ("pause_live", 6), ("unpause", 14),
            ("reconf", 10), ("attach", 10), ("detach", 6), ("migrate", 7),
            ("fault", 6))


def generate_scenario(cfg: ScenarioConfig) -> tuple[Op, ...]:
    rng = random.Random(0x5FF ^ (cfg.seed * 2654435761 % 2**31))
    ops: list[Op] = []
    serve = cfg.serve_rate > 0 and cfg.max_vfs >= 2
    mig = serve and cfg.migrate_rate > 0

    nvf = rng.randint(1, min(4, cfg.max_vfs))
    per = rng.choice([1, 2]) if cfg.num_devices >= 4 * nvf else 1
    m = rng.randint(1, nvf)
    if serve:
        # make room for the dedicated serving tenant sv0 (and, with
        # migration traffic, the target engine sv1): one/two more VFs
        # than train tenants, within BOTH the VF and the device budget
        extra = 2 if mig else 1
        nvf = min(max(nvf, m + extra), cfg.max_vfs, cfg.num_devices)
        m = min(m, nvf - extra) or 1
        if per * nvf > cfg.num_devices:
            per = 1
        if nvf < 2:
            serve = mig = False      # no room for a second VF: no sv0
        elif nvf < m + 2:
            mig = False              # no room for sv1: no migrations
    pipe = cfg.reshape_rate > 0
    if pipe:
        # the gang lead pg0 spans up to 3 VFs (width alternates 2<->3):
        # enable only when trainers + serve engines + the gang at max
        # width all fit the VF and device budgets
        sv_extra = (2 if mig else 1) if serve else 0
        want = m + sv_extra + 3
        if want <= min(cfg.max_vfs, cfg.num_devices):
            nvf = max(nvf, want)
            if per * nvf > cfg.num_devices:
                per = 1
        else:
            pipe = False
    ops.append(Op("init", num_vfs=nvf, devices_per_vf=per, num_tenants=m))

    # validity model
    running = [f"vm{i}" for i in range(m)]
    paused: list[str] = []
    detached: list[str] = []
    next_id = m
    total_vfs = nvf          # conservative lower bound (see sim README)
    if serve:
        # sv0 joins the shared validity model: pause/pause_live/unpause/
        # migrate/step pick it like any tenant; detach/fault never do
        ops.append(Op("attach", tenant="sv0"))
        ops.append(Op("serve_submit", tenant="sv0",
                      burst=rng.choice([1, 2, 3])))
        running.append("sv0")
        if mig:
            # the migration target engine: joins the shared validity
            # model like sv0 (pause/unpause/migrate/step may pick it;
            # detach/fault never do), so migrate_request ops compose
            # with live pauses and autoscaling
            ops.append(Op("attach", tenant="sv1"))
            running.append("sv1")
    gang_k = 0
    if pipe:
        # the gang lead stays OUT of the shared validity model: its
        # width changes are driven exclusively by reshape ops, never by
        # pause/detach/fault/migrate draws. ``gang_k`` tracks how many
        # VFs the gang occupies (lead + width-1 shells) so the attach /
        # reconf budgets below stay honest.
        ops.append(Op("attach", tenant="pg0"))      # harness: attach_group
        ops.append(Op("serve_submit", tenant="pg0",
                      burst=rng.choice([1, 2])))
        gang_k = 2

    def tenant_count():
        return len(running) + len(paused) + len(detached) + 0

    while len(ops) < cfg.num_ops:
        # gated on truthiness so autoscale_rate=0 draws nothing and the
        # pre-autoscale op stream stays byte-identical (same trick as
        # crash_rate below)
        if serve and cfg.autoscale_rate and \
                rng.random() < cfg.autoscale_rate:
            ops.append(Op("autoscale"))
            continue
        if gang_k and rng.random() < cfg.reshape_rate:
            # gated on gang_k truthiness so reshape_rate=0 draws nothing
            r = rng.random()
            if r < 0.4:
                k_new = 3 if gang_k == 2 else 2
                free = total_vfs - len(running) - len(paused) - gang_k
                if k_new > gang_k and free < k_new - gang_k:
                    # no idle VF for the extra shell: serve instead
                    ops.append(Op("serve_step", tenant="pg0", steps=1))
                else:
                    ops.append(Op("reshape", tenant="pg0",
                                  num_vfs=k_new))
                    gang_k = k_new
            elif r < 0.7:
                ops.append(Op("serve_submit", tenant="pg0",
                              burst=rng.choice([1, 2, 3])))
            else:
                ops.append(Op("serve_step", tenant="pg0",
                              steps=rng.randint(1, 2)))
            continue
        if mig and rng.random() < cfg.migrate_rate:
            # harness picks the (src, dst) pair deterministically among
            # the running serving engines; no pair / nothing in flight
            # is a no-op, so the op is valid regardless of model state
            ops.append(Op("migrate_request"))
            continue
        if serve and rng.random() < cfg.serve_rate:
            op = _serve_op(rng, cfg, len(ops) / max(cfg.num_ops, 1),
                           running, paused)
            if op is not None:
                ops.append(op)
                continue
        if cfg.crash_rate and rng.random() < cfg.crash_rate:
            # crash ops mutate the model per the cataloged recovery
            # outcome, so the sequence stays valid after the recovery
            # (gang VFs are subtracted so attach triggers stay reachable)
            op = _crash_op(rng, cfg, running, paused, detached,
                           total_vfs - gang_k, next_id)
            if op is not None:
                if op.trigger == "attach" and op.tenant == f"vm{next_id}":
                    next_id += 1
                ops.append(op)
                continue
        if rng.random() < cfg.chaos_rate:
            op = _chaos_op(rng, running, paused, detached, next_id)
            if op is not None:
                ops.append(op)
                continue
        kind = _weighted(rng)
        if kind == "step" and running:
            ops.append(Op("step", tenant=rng.choice(sorted(running)),
                          steps=rng.randint(1, 3)))
        elif kind in ("pause", "pause_live") and running:
            t = rng.choice(sorted(running))
            running.remove(t); paused.append(t)
            ops.append(Op(kind, tenant=t))
        elif kind == "unpause" and paused:
            t = rng.choice(sorted(paused))
            paused.remove(t); running.append(t)
            ops.append(Op("unpause", tenant=t))
        elif kind == "reconf":
            # gang members (lead + shells) hold VFs like any live tenant
            occupied = len(running) + len(paused) + gang_k
            lo = 1
            hi = cfg.max_vfs
            n = rng.randint(lo, hi)
            # budget so survivors + creations + later unpauses always fit
            p = 1 if cfg.num_devices < 2 * (n + occupied) else \
                rng.choice([1, 2])
            if p * (n + occupied) > cfg.num_devices:
                p = 1
            if n < len(running) + gang_k:    # keep every live tenant placeable
                n = (len(running) + gang_k) or 1
            ops.append(Op("reconf", num_vfs=n, devices_per_vf=p))
            total_vfs = max(n, occupied)
        elif kind == "attach":
            free = total_vfs - len(running) - len(paused) - gang_k
            if free <= 0:
                continue
            if detached and rng.random() < 0.5:
                t = rng.choice(sorted(detached))
                detached.remove(t)
            elif tenant_count() < cfg.max_tenants:
                t = f"vm{next_id}"; next_id += 1
            else:
                continue
            running.append(t)
            ops.append(Op("attach", tenant=t))
        elif kind == "detach" and _nonserve(running):
            # the serving tenant is never detached: its request plane
            # (queue/in-flight batch) lives in guest RAM, which detach
            # (unlike pause) does not preserve
            t = rng.choice(_nonserve(running))
            running.remove(t); detached.append(t)
            ops.append(Op("detach", tenant=t))
        elif kind == "migrate" and running:
            ops.append(Op("migrate", tenant=rng.choice(sorted(running))))
        elif kind == "fault" and _nonserve(running):
            ops.append(Op("fault", tenant=rng.choice(_nonserve(running))))
    return tuple(ops)


def _nonserve(tenants: list) -> list:
    return sorted(t for t in tenants if not t.startswith("sv"))


def _serve_op(rng: random.Random, cfg: ScenarioConfig, frac: float,
              running, paused) -> Optional[Op]:
    """Serve-traffic op: arrivals per ``cfg.arrival`` (the queue accepts
    even while the engine is PAUSED — the guest keeps its device) and
    engine steps (only legal while running)."""
    if "sv0" in running:
        if rng.random() < 0.55:
            return Op("serve_submit", tenant="sv0",
                      burst=_burst(rng, cfg, frac))
        return Op("serve_step", tenant="sv0", steps=rng.randint(1, 3))
    if "sv0" in paused:
        return Op("serve_submit", tenant="sv0",
                  burst=rng.choice([1, 2]))
    return None


def _burst(rng: random.Random, cfg: ScenarioConfig, frac: float) -> int:
    """Burst size for one serve_submit. ``bursty`` reproduces the original
    draw byte-for-byte; the others shape arrivals over scenario progress
    ``frac`` (the traffic traces the autoscaler is exercised against)."""
    if cfg.arrival == "ramp":
        return rng.choice([1, 2]) + int(6 * frac)      # bursty-ramp
    if cfg.arrival == "spike":
        return 12 if rng.random() < 0.12 else rng.choice([1, 1, 2])
    if cfg.arrival == "diurnal":
        import math
        base = 1 + int(4 * (0.5 - 0.5 * math.cos(2 * math.pi * frac)))
        return base + rng.choice([0, 1])
    return rng.choice([1, 1, 2, 3, 6])                 # bursty (default)


def _weighted(rng: random.Random) -> str:
    total = sum(w for _, w in _WEIGHTS)
    x = rng.randrange(total)
    for kind, w in _WEIGHTS:
        if x < w:
            return kind
        x -= w
    return "step"


def _crash_op(rng, cfg, running, paused, detached, total_vfs,
              next_id) -> Optional[Op]:
    """A crash-injection op that is guaranteed to reach its crash point,
    with the model advanced to the cataloged recovery outcome."""
    from repro_torch.sim.chaos import CRASH_POINTS

    cands = []                       # (point, trigger, tenant | None)
    free = total_vfs - len(running) - len(paused)
    can_new = (len(running) + len(paused) + len(detached)
               < cfg.max_tenants)
    for point in sorted(CRASH_POINTS):
        spec = CRASH_POINTS[point]
        for trig in spec.triggers:
            if trig in ("pause", "pause_live") and running:
                cands.append((point, trig, rng.choice(sorted(running))))
            elif trig == "detach" and _nonserve(running):
                cands.append((point, trig, rng.choice(_nonserve(running))))
            elif trig == "unpause" and paused:
                cands.append((point, trig, rng.choice(sorted(paused))))
            elif trig == "attach" and free > 0:
                if detached and (not can_new or rng.random() < 0.5):
                    cands.append((point, trig,
                                  rng.choice(sorted(detached))))
                elif can_new:
                    cands.append((point, trig, f"vm{next_id}"))
            elif trig == "qmp":
                cands.append((point, trig, None))
            elif trig in ("migrate_request", "attach_group", "reshape"):
                # needs preconditions the validity model cannot track
                # (an in-flight request + target KV headroom, or a gang
                # lead with the right shell/VF configuration); these
                # crash windows are covered by the run_crash_case
                # matrix instead
                continue
    if not cands:
        return None
    point, trig, t = cands[rng.randrange(len(cands))]
    if CRASH_POINTS[point].outcome == "complete":
        if trig == "attach":
            if t in detached:
                detached.remove(t)
            running.append(t)
        elif trig in ("pause", "pause_live"):
            running.remove(t); paused.append(t)
        elif trig == "detach":
            running.remove(t); detached.append(t)
        elif trig == "unpause":
            paused.remove(t); running.append(t)
    return Op("crash", tenant=t, point=point, trigger=trig)


def _chaos_op(rng, running, paused, detached, next_id) -> Optional[Op]:
    """An op the manager must REJECT without corrupting state."""
    choices = []
    if paused:
        choices += [Op("detach", tenant=rng.choice(sorted(paused)),
                       chaos=True),            # paused VF can't detach
                    Op("pause", tenant=rng.choice(sorted(paused)),
                       chaos=True),            # double pause
                    Op("pause_live", tenant=rng.choice(sorted(paused)),
                       chaos=True),            # live pause of paused VF
                    Op("step", tenant=rng.choice(sorted(paused)),
                       chaos=True)]            # I/O while paused
    if running:
        choices += [Op("unpause", tenant=rng.choice(sorted(running)),
                       chaos=True),            # not paused
                    Op("attach", tenant=rng.choice(sorted(running)),
                       chaos=True)]            # already attached
    if detached:
        choices += [Op("pause", tenant=rng.choice(sorted(detached)),
                       chaos=True)]            # no VF to pause
    if not choices:
        return None
    return rng.choice(choices)
