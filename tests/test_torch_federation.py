"""The port's federation control plane (``repro_torch.core.host``,
``repro_torch.core.federation``, the manager's ``peer_lookup`` /
``dst_host``, ``MetricsBus.replicate``, ``ServeFleet.federation_snapshot``
and ``bench.federation``) against the JAX package's, on the CPU.

Each case of ``tests/test_federation.py`` that drives the control plane
runs on both packages with the same seeds and ops, and what it observes
must be equal: routing choices, lease books, epoch fences, residency,
owners, token streams, journals and fingerprints. On top of those:

* two ``Host``s each holding a smoke-width qwen3-0.6b engine tenant
  (fp32 compute, the JAX init's params converted) through a clean
  cross-host migration in both directions and both migrate fault
  windows (``chip_smoke.federation_engines``, the card phase's driver):
  the streams equal the JAX twin's and an undisturbed engine's, the
  journals equal the JAX twin's, and the shipped state is restored onto
  the target engine's own device with no VF read from the source pool;
* ``MetricsBus.replicate`` and ``federation_snapshot`` on the same fleet
  traffic as the JAX fleet's, the wall-clock percentiles left out (they
  time the host, not the protocol);
* ``bench.federation --reduced``: the JAX benchmark's rows, digests
  included, apart from ``wall_s``, ``admits_per_s`` and ``tokens_per_s``.
"""
import dataclasses
import importlib.util
import inspect
import os
import pathlib
import random
import types

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.sim as jsim
import repro.sim.federation as jfed
import repro_torch.core as tcore
import repro_torch.sim as tsim
import repro_torch.sim.federation as tfed
from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.models.model import build_model as jax_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.fleet import EngineTenant as JEngineTenant
from repro.serve.fleet import ServeFleet as JFleet
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.fleet import EngineTenant as TEngineTenant
from repro_torch.serve.fleet import ServeFleet as TFleet

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load("chip_smoke", ROOT / "chip_smoke.py")
JAX_BENCH = _load("jax_federation_bench", ROOT / "benchmarks" / "federation.py")

#: the two packages' federation surfaces; ``cell`` builds a fed cell with
#: the sim tenants' state on the CPU
JAX = types.SimpleNamespace(
    core=jcore, sim=jsim, fed=jfed,
    cell=lambda seed, wd: jfed.build_fed_cell(seed, workdir=str(wd)))
PORT = types.SimpleNamespace(
    core=tcore, sim=tsim, fed=tfed,
    cell=lambda seed, wd: tfed.build_fed_cell(seed, workdir=str(wd),
                                              device="cpu"))
SIDES = (JAX, PORT)


def _both(body, tmp_path):
    """Run ``body(side, workdir)`` on both packages; return both traces."""
    return [body(side, tmp_path / name)
            for side, name in zip(SIDES, ("jax", "port"))]


def _leases(co):
    return {h: dataclasses.astuple(l) for h, l in sorted(co.leases.items())}


# ---------------------------------------------------------------------------
# choose_host
# ---------------------------------------------------------------------------
def test_choose_host_policies_match_jax():
    """The JAX cases, then 200 random candidate lists: the same host (or
    the same typed rejection) under every policy and need."""
    for side in SIDES:
        cands = [side.core.HostCandidate("a", load=4, capacity=8),
                 side.core.HostCandidate("b", load=1, capacity=8),
                 side.core.HostCandidate("c", load=6, capacity=8)]
        assert side.core.choose_host("first_fit", cands).host_id == "a"
        assert side.core.choose_host("best_fit", cands).host_id == "c"
        assert side.core.choose_host("fair_share", cands).host_id == "b"
    rng = random.Random(7)
    for _ in range(200):
        spec = [(f"h{i}", rng.randint(0, 8), rng.choice([4, 8]))
                for i in range(rng.randint(0, 5))]
        need = rng.randint(1, 4)
        for policy in jcore.POLICY_NAMES:
            picks = []
            for side in SIDES:
                cands = [side.core.HostCandidate(h, load=ld, capacity=cap)
                         for h, ld, cap in spec]
                try:
                    picks.append(side.core.choose_host(policy, cands,
                                                       need).host_id)
                except side.core.AdmissionError:
                    picks.append("rejected")
            assert picks[0] == picks[1], (spec, need, policy, picks)


def test_choose_host_respects_need_and_rejects_typed():
    for side in SIDES:
        cands = [side.core.HostCandidate("a", load=7, capacity=8),
                 side.core.HostCandidate("b", load=5, capacity=8)]
        assert side.core.choose_host("first_fit", cands, need=2).host_id \
            == "b"
        with pytest.raises(side.core.AdmissionError):
            side.core.choose_host("first_fit", cands, need=4)
        with pytest.raises(KeyError):
            side.core.choose_host("no_such_policy", cands)
    assert issubclass(tcore.AdmissionError, tcore.PoolError)


# ---------------------------------------------------------------------------
# leases, heartbeats, fences
# ---------------------------------------------------------------------------
def test_lease_grant_expiry_renewal(tmp_path):
    def body(side, wd):
        cell = side.cell(0, wd)
        co, clock = cell["coordinator"], cell["clock"]
        trace = [co.live_hosts(), _leases(co)]
        clock.advance(side.fed.LEASE_TTL + 0.1)
        trace.append(co.live_hosts())
        assert co.live_hosts() == []
        with pytest.raises(side.core.LeaseExpiredError):
            co.migrate_request("h0", "h1")
        beat = co.heartbeat_all()
        trace += [beat, co.live_hosts(), _leases(co),
                  sorted(co.snapshots.items())]
        assert beat["renewed"] == ["h0", "h1", "h2"]
        assert all(s["pulled_at"] == beat["t"]
                   for s in co.snapshots.values())
        return trace
    jax_trace, port_trace = _both(body, tmp_path)
    assert port_trace == jax_trace


def test_partitioned_host_keeps_aging_lease(tmp_path):
    def body(side, wd):
        cell = side.cell(1, wd)
        co, clock, fabric = (cell["coordinator"], cell["clock"],
                             cell["fabric"])
        fabric.partition([co.node_id, "h1", "h2"], ["h0"])
        clock.advance(1.0)
        trace = [co.heartbeat_all(), co.live_hosts(), _leases(co)]
        assert "h0" in co.live_hosts()
        clock.advance(side.fed.LEASE_TTL - 0.5)
        trace += [co.live_hosts(),
                  [dataclasses.astuple(c) for c in co._candidates()]]
        assert "h0" not in co.live_hosts()
        return trace
    jax_trace, port_trace = _both(body, tmp_path)
    assert port_trace == jax_trace


def test_epoch_fence_monotone(tmp_path):
    def body(side, wd):
        h = side.core.Host("hx", workdir=str(wd), clock=side.sim.VirtualClock())
        trace = []
        for epoch in (3, 3, 5, 4, 6, 2):
            try:
                h.check_epoch(epoch)
                trace.append(("ok", h.fence_epoch))
            except side.core.SplitBrainError:
                trace.append(("fenced", h.fence_epoch))
        trace.append(h.telemetry.describe())
        trace.append(h.describe())
        return trace
    jax_trace, port_trace = _both(body, tmp_path)
    assert port_trace == jax_trace
    assert port_trace[3] == ("fenced", 5) and port_trace[-2]["fenced"] == 2


def test_handoff_fences_old_coordinator(tmp_path):
    def body(side, wd):
        cell = side.cell(2, wd)
        co = cell["coordinator"]
        r_old = co.submit(seed=7)
        succ = co.handoff()
        trace = [r_old, succ.epoch, succ.node_id,
                 [h.fence_epoch for h in cell["hosts"]], _leases(succ)]
        assert all(h.fence_epoch == succ.epoch for h in cell["hosts"])
        with pytest.raises((side.core.AdmissionError,
                            side.core.SplitBrainError)):
            co.submit(seed=7)
        trace += [_leases(co), co.rejections]
        r_new = succ.submit(seed=7)
        assert r_new["rid"] != r_old["rid"]
        assert r_new["rid"] // side.core.federation.RID_STRIDE == succ.epoch
        side.sim.check_federation(cell["hosts"], [succ, co])
        trace += [r_new, succ.describe(), co.describe(),
                  side.fed.federation_fingerprint(cell["hosts"], succ)]
        return trace
    jax_trace, port_trace = _both(body, tmp_path)
    assert port_trace == jax_trace


# ---------------------------------------------------------------------------
# cross-host request migration with sim tenants; submit
# ---------------------------------------------------------------------------
def test_cross_host_migrate_roundtrip_token_identical(tmp_path):
    def body(side, wd):
        cell = side.cell(4, wd)
        co, hosts = cell["coordinator"], cell["hosts"]
        subs = [co.submit(seed=11) for _ in range(3)]
        res = max(subs, key=lambda r: side.sim.SimServeTenant.make_max_new(
            11, r["rid"]))
        src = next(h for h in hosts if h.host_id == res["host"])
        for tn in src.serve_targets():
            tn.run_steps(1)
        dst_id = "h1" if res["host"] != "h1" else "h2"
        out = co.migrate_request(res["host"], dst_id, res["rid"])
        out.pop("migrate_request_s")
        dst = next(h for h in hosts if h.host_id == dst_id)
        owners = (dst.owner_engine(res["rid"]).tid,
                  src.owner_engine(res["rid"]))
        assert owners[1] is None and co.residency[res["rid"]] == dst_id
        side.sim.check_federation(hosts, [co])
        for host in hosts:
            side.sim.check_invariants(host.mgr)
        for _ in range(40):
            for host in hosts:
                for tn in host.serve_targets():
                    tn.run_steps(1)
        want = side.sim.SimServeTenant.expected_output(11, res["rid"])
        got = next(r for host in hosts for tn in host.serve_targets()
                   for r in tn.requests if r.rid == res["rid"])
        assert got.done and list(got.out) == want
        return [subs, out, owners, sorted(co.residency.items()),
                [h.snapshot() for h in hosts],
                side.fed.federation_fingerprint(hosts, co)]
    jax_trace, port_trace = _both(body, tmp_path)
    assert port_trace == jax_trace


def test_submit_exactly_once_and_reroute(tmp_path):
    def body(side, wd):
        cell = side.cell(5, wd)
        co = cell["coordinator"]
        res = co.submit(seed=3)
        with pytest.raises(side.core.FederationError):
            co.submit(rid=res["rid"], seed=3)
        cell["fabric"].arm("fed_submit_route",
                           [co.node_id, "h1", "h2"], ["h0"])
        res2 = co.submit(seed=3)
        assert res2["host"] != "h0" and not res2["in_doubt"]
        owners = [h.host_id for h in cell["hosts"]
                  if h.owner_engine(res2["rid"]) is not None]
        assert owners == [res2["host"]]
        return [res, res2, owners, cell["fabric"].fired,
                sorted(co.residency.items()), co.describe()]
    jax_trace, port_trace = _both(body, tmp_path)
    assert port_trace == jax_trace


# ---------------------------------------------------------------------------
# real engines on two hosts (the card phase's driver, at smoke width)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen():
    jrun = jax_run_config("qwen3-0.6b", "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"))
    trun = torch_run_config("qwen3-0.6b", "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"))
    jp = jax_model(jrun).init(jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jrun, jp, trun, tp


def fed_requests(cls, n=10, new=16):
    """Greedy and sampled requests (temperature 0.8, top-k 0 or 16) of one
    prompt length (one prefill shape for the JAX engine to compile)."""
    return [cls(rid=i, prompt=(np.arange(8) * (i + 2) + 1)
                % 500, max_new_tokens=new,
                temperature=0.8 if i % 2 else 0.0,
                top_k=16 if i % 4 == 1 else 0, seed=3 + i)
            for i in range(n)]


FED_ENGINE_KW = dict(slots=4, max_len=64, page_size=8)


def test_engine_hosts_cross_host_migration_matches_jax(qwen, tmp_path,
                                                       monkeypatch):
    """``chip_smoke.federation_engines`` at smoke width on both packages:
    8 clean migrations in both directions, 3 mid-ship deferrals rolled
    back and 3 after-admit deferrals rolled forward, the ownership witness
    at every step. Streams and journals equal the JAX twin's, the streams
    an undisturbed engine's; the target's pages land on the target
    engine's device, restored there with no VF read from the source
    host's pool (both hosts name their VFs alike)."""
    jrun, jp, trun, tp = qwen
    jkit = dict(Host=jcore.Host, Coordinator=jcore.FederationCoordinator,
                Fabric=jcore.Fabric, Clock=jsim.VirtualClock,
                Tenant=JEngineTenant,
                Unreachable=jcore.HostUnreachableError,
                check_invariants=jsim.check_invariants,
                fingerprint=jsim.federation_fingerprint,
                engine=lambda run, params, **kw: JEngine(run, params, **kw))
    want = CS.federation_engines(jkit, jrun, jp, str(tmp_path / "jax"),
                                 fed_requests(JRequest), **FED_ENGINE_KW)

    placed, restored = [], []

    class SpyTenant(TEngineTenant):
        def shardings_for(self, vf):
            dev = super().shardings_for(vf)
            placed.append((self.tid, vf, dev))
            return dev

    restore = tcore.StagingEngine.restore

    def spy_restore(self, staged, device=None):
        restored.append(device)
        return restore(self, staged, device)

    monkeypatch.setattr(tcore.StagingEngine, "restore", spy_restore)
    tkit = dict(CS.port_federation_kit(torch.device("cpu")), Tenant=SpyTenant)
    got = CS.federation_engines(tkit, trun, tp, str(tmp_path / "port"),
                                fed_requests(TRequest), **FED_ENGINE_KW)
    kinds = [m["kind"] for m in got["migrations"]]
    assert kinds == list(CS.FED_PLAN)
    assert {(m["src"], m["dst"]) for m in got["migrations"]
            if m["kind"] == "clean"} == {("h0", "h1"), ("h1", "h0")}
    assert got["streams"] == want["streams"]
    assert got["journals"] == want["journals"]
    assert ([(m["kind"], m["rid"], m["src"]) for m in got["migrations"]]
            == [(m["kind"], m["rid"], m["src"]) for m in want["migrations"]])
    # every cross-host restore: no VF, the target engine's own device
    engines = {tn.tid: tn.engine for tn in got["tenants"]}
    assert len(placed) == len(CS.FED_PLAN)
    assert all(vf is None and dev == engines[tid].device
               for tid, vf, dev in placed)
    assert restored[-len(placed):] == [dev for _, _, dev in placed]
    assert all(t.device == engines[tid].device
               for tid, eng in engines.items()
               for blk in eng._cache.values() for t in blk.values()
               if isinstance(t, torch.Tensor))
    # an undisturbed engine serving the same requests
    eng = TEngine(trun, tp, device="cpu", paged=True,
                  fused_sampling=True, **FED_ENGINE_KW)
    reqs = fed_requests(TRequest)
    for r in reqs:
        eng.submit(r)
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
    assert [list(r.out) for r in reqs] == got["streams"]


def test_manager_peer_lookup_signatures_match_jax():
    """``peer_lookup`` on ``SVFFManager.__init__`` and ``recover``, and
    ``dst_host`` on ``migrate_request``, as in the JAX manager."""
    for name in ("recover", "migrate_request"):
        jsig = inspect.signature(getattr(jcore.SVFFManager, name))
        tsig = inspect.signature(getattr(tcore.SVFFManager, name))
        assert list(tsig.parameters) == list(jsig.parameters), name
    tinit = inspect.signature(tcore.SVFFManager.__init__).parameters
    assert tinit["peer_lookup"].default is None
    for cls in ("Host", "FederationCoordinator", "Fabric", "RemoteTenant"):
        jm = {n for n in dir(getattr(jcore, cls)) if not n.startswith("_")}
        tm = {n for n in dir(getattr(tcore, cls)) if not n.startswith("_")}
        assert jm <= tm, (cls, jm - tm)


# ---------------------------------------------------------------------------
# satellites: journal compaction, errors, exports, staleness
# ---------------------------------------------------------------------------
def test_journal_auto_compaction_recovery_green(tmp_path):
    from repro_torch.core.journal import OpJournal
    from repro_torch.sim.chaos import recover_manager, state_fingerprint
    clock = tsim.VirtualClock()
    wd = str(tmp_path)
    pool = tcore.DevicePool(devices=tuple(f"cd{i}" for i in range(8)),
                            max_vfs=4)
    journal = OpJournal(os.path.join(wd, "journal"), compact_every=6,
                        compact_keep=4)
    mgr = tcore.SVFFManager(pool, staging=tcore.StagingEngine(num_queues=2),
                            workdir=wd, scheduler="first_fit",
                            journal=journal)
    tenants = [tsim.SimServeTenant(f"hc.sv{j}", seed=j, clock=clock,
                                   device="cpu") for j in range(2)]
    mgr.init(num_vfs=3, tenants=tenants, devices_per_vf=2)
    for i in range(10):
        tn = tenants[i % 2]
        mgr.pause(tn)
        mgr.unpause(tn)
    entries = list(journal.iter_entries())
    assert len(entries) <= 10
    assert journal.pending() == []
    tsim.check_invariants(mgr)
    before = state_fingerprint(mgr)
    mgr2 = recover_manager(mgr, {tn.tid: tn for tn in tenants},
                           policy="first_fit", workdir=wd)
    tsim.check_invariants(mgr2)
    assert state_fingerprint(mgr2) == before


def test_error_hierarchy_and_core_exports_match_jax():
    import repro_torch.core.errors as errors
    import repro_torch.serve.paged as paged
    assert paged.DoubleFreeError is tcore.DoubleFreeError
    assert paged.UnknownRequestError is tcore.UnknownRequestError
    assert tcore.DoubleFreeError is errors.DoubleFreeError
    for exc in (tcore.FederationError, tcore.HostUnreachableError,
                tcore.LeaseExpiredError, tcore.SplitBrainError):
        assert issubclass(exc, tcore.ManagerError)
    assert issubclass(tcore.UnknownTenantError, tcore.ManagerError)
    assert issubclass(tcore.GangPlacementError, tcore.AdmissionError)
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    assert sorted(tsim.__all__) == sorted(set(jsim.__all__)
                                          | {"PORTED_POINTS",
                                             "SimPipelineTenant"})
    for mod in (tcore, tsim):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name
    # the same mro names, class by class, for the error types
    for name in ("FederationError", "HostUnreachableError",
                 "LeaseExpiredError", "SplitBrainError", "ManagerError",
                 "AdmissionError", "GangPlacementError"):
        assert ([c.__name__ for c in getattr(tcore, name).__mro__]
                == [c.__name__ for c in getattr(jcore, name).__mro__])


def _snap(core, age, load=6):
    return core.TelemetrySnapshot(
        epoch=1, slo_max_load=6, free_vfs=1, age_s=age,
        engines=(core.EngineStats(tid="e0", index=0, status="running",
                                  load=load),))


def test_stale_snapshot_suppresses_and_freezes_streaks():
    trace = []
    for side in SIDES:
        sc = side.core.Autoscaler(side.core.AutoscaleConfig(
            hysteresis=2, cooldown=0, max_staleness_s=2.0))
        seq = [sc.observe(_snap(side.core, 0.0))]
        for _ in range(5):
            seq.append(sc.observe(_snap(side.core, 3.0)))
        seq.append(sc._hot_streak)
        act = sc.observe(_snap(side.core, 0.0))
        assert act is not None and act.kind == "scale_out"
        assert side.core.justify_action(act, sc.cfg) is None
        trace.append(seq[:-1] == [None] * 6 and seq[-1] == 1)
    assert trace == [True, True]


def test_justify_rejects_stale_planned_action():
    errs = []
    for side in SIDES:
        cfg = side.core.AutoscaleConfig(max_staleness_s=2.0)
        act = side.core.AutoscaleAction("scale_out", _snap(side.core, 5.0))
        errs.append(side.core.justify_action(act, cfg))
    assert errs[0] is not None and "stale" in errs[0]
    assert errs[1] == errs[0]


# ---------------------------------------------------------------------------
# MetricsBus.replicate and ServeFleet.federation_snapshot
# ---------------------------------------------------------------------------
WALL_CLOCK = ("ttft_p95_ms", "itl_p95_ms")


def _no_wall_clock(engines: dict) -> dict:
    """The replica's per-engine view without its wall-clock percentiles:
    they time this host's steps, not the protocol."""
    return {tid: {k: v for k, v in e.items() if k not in WALL_CLOCK}
            for tid, e in engines.items()}


def test_metricsbus_replicate_and_federation_snapshot_match_jax(qwen,
                                                                tmp_path):
    """The same fleet traffic on both packages (two engines, requests
    submitted, stepped, one rejection): ``federation_snapshot(now)`` and
    the bus replica inside it equal the JAX fleet's, apart from the
    wall-clock latency percentiles."""
    from repro_torch.serve.telemetry import MetricsBus
    from repro.serve.telemetry import MetricsBus as JBus
    assert JBus().replicate(12.5) == MetricsBus().replicate(12.5)
    jrun, jp, trun, tp = qwen
    snaps = []
    for side in ("jax", "port"):
        kw = dict(num_engines=2, num_devices=4, slots=2, max_len=48,
                  page_size=8, slo_max_load=3,
                  workdir=str(tmp_path / side), host_id="h7")
        if side == "jax":
            fleet, cls = JFleet(jrun, jp, **kw), JRequest
        else:
            fleet, cls = TFleet(trun, tp, device="cpu", **kw), TRequest
        out = []
        for r in fed_requests(cls, n=7, new=6):
            try:
                fleet.submit(r)
                out.append("ok")
            except Exception as e:               # the typed rejection
                out.append(type(e).__name__)
        for _ in range(3):
            fleet.step()
        snap = fleet.federation_snapshot(12.5)
        snap["telemetry"]["engines"] = _no_wall_clock(
            snap["telemetry"]["engines"])
        snaps.append((out, snap))
    assert snaps[1] == snaps[0]
    out, snap = snaps[1]
    assert "RequestRejected" in out and snap["stamp"] == 12.5
    assert snap["telemetry"]["stamp"] == 12.5 and snap["host_id"] == "h7"
    assert tuple(sorted(snap)) == CS.FED_SNAPSHOT_KEYS
    assert tuple(sorted(snap["telemetry"])) == CS.FED_REPLICA_KEYS


# ---------------------------------------------------------------------------
# bench.federation
# ---------------------------------------------------------------------------
def test_bench_federation_reduced_matches_jax(capsys):
    from repro_torch.bench import federation as tbench
    wall = ("wall_s", "admits_per_s", "tokens_per_s")
    args = dict(hosts=3, engines_per_host=16, requests=3_000,
                policy="fair_share", seed=0, partition_rate=0.05,
                reduced=True)
    want = JAX_BENCH.bench(**args)
    got = tbench.bench(**args)
    strip = [{k: v for k, v in r.items() if k not in wall} for r in got]
    assert strip == [{k: v for k, v in r.items() if k not in wall}
                     for r in want]
    assert got[-1]["all_gates"] and got[0]["digest"] == got[1]["digest"]
    assert tbench.main(["--reduced", "--hosts", "2", "--engines-per-host",
                        "4", "--requests", "400"]) == 0
    capsys.readouterr()
