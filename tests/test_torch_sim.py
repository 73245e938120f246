"""The port's sim plane (``repro_torch.sim``) against the JAX package's
(``repro.sim``), on the CPU.

The JAX package is the oracle, run on the same seeds and configs:

* ``generate_scenario`` emits the same op tuples, for every tested seed
  and config (the rates the port's runner refuses included);
* ``ScenarioRunner(cfg, device="cpu").run()`` gives the same
  ``fingerprint()``, ``num_ok``, ``num_rejected`` and ``virtual_seconds``,
  and every final ``SimTenant`` leaf is bit-equal to the JAX tenant's
  ``export_state()`` (exact: fp32 adds of the same numpy draws);
* ``run_crash_case`` gives the same rows for each of the 15 ported crash
  points (the four ``migrate_*`` windows included);
* with nonzero autoscale and migrate rates the runners agree too, and the
  serving sim tenant's migration methods match the JAX tenant's;
* the checker bites (I4, I10, I12), and the unported reshape op, rate and
  gang crash points raise ``NotImplementedError`` naming their ROADMAP
  item;
* the three benchmarks in ``repro_torch.bench`` run and print the JAX
  benchmarks' report keys (the committed ``BENCH_*.json`` of the JAX
  package).
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.sim as jsim
import repro_torch.sim as tsim
from repro.core.manager import SVFFManager as JManager
from repro.core.pool import DevicePool as JPool
from repro.core.staging import StagingEngine as JStaging
from repro.sim.chaos import run_crash_case as jax_crash_case
from repro_torch.bench import crash_matrix as tcrash
from repro_torch.bench import pause_path as tpause
from repro_torch.bench import scenario_sweep as tsweep
from repro_torch.core import DevicePool, SVFFManager, StagingEngine
from repro_torch.tree import flatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
POLICIES = ("first_fit", "best_fit", "fair_share")

GEN_CONFIGS = {
    "default": {},
    "serve": {"serve_rate": 0.3},
    "crash": {"crash_rate": 0.1},
    **{f"arrival_{a}": {"serve_rate": 0.3, "arrival": a}
       for a in ("bursty", "ramp", "spike", "diurnal")},
    "autoscale": {"serve_rate": 0.3, "autoscale_rate": 0.1},
    "migrate": {"serve_rate": 0.3, "migrate_rate": 0.2},
    "reshape": {"serve_rate": 0.3, "reshape_rate": 0.25, "max_vfs": 8},
}


@pytest.mark.parametrize("name", sorted(GEN_CONFIGS))
def test_generator_matches_jax(name):
    """The generator is pure ``random`` code: the same op tuples as the JAX
    package's, seeds 0-49."""
    kw = GEN_CONFIGS[name]
    kinds = set()
    for seed in range(50):
        want = jsim.generate_scenario(jsim.ScenarioConfig(seed=seed, **kw))
        got = tsim.generate_scenario(tsim.ScenarioConfig(seed=seed, **kw))
        assert ([dataclasses.astuple(o) for o in got]
                == [dataclasses.astuple(o) for o in want]), seed
        kinds |= {o.kind for o in got}
    for rate, kind in (("autoscale_rate", "autoscale"),
                       ("migrate_rate", "migrate_request"),
                       ("reshape_rate", "reshape")):
        assert (kind in kinds) == (rate in kw), (kind, sorted(kinds))


def test_scenario_config_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jsim.ScenarioConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tsim.ScenarioConfig)]
    assert tf == jf
    assert tsim.OP_KINDS == jsim.OP_KINDS
    assert tsim.ARRIVAL_PATTERNS == jsim.ARRIVAL_PATTERNS


def test_crash_catalogue_matches_jax():
    """All 19 points kept as data (the generator draws from them), the 15
    of the core ops and request migration recovered."""
    assert ({k: dataclasses.astuple(v) for k, v in tsim.CRASH_POINTS.items()}
            == {k: dataclasses.astuple(v)
                for k, v in jsim.CRASH_POINTS.items()})
    assert len(tsim.CRASH_POINTS) == 19
    assert len(tsim.PORTED_POINTS) == 15
    assert len([p for p in tsim.PORTED_POINTS
                if p.startswith("migrate_")]) == 4
    assert not [p for p in tsim.PORTED_POINTS
                if p.startswith(("gang_", "reshape_"))]


def _leaves(tree) -> dict:
    return {path: np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for path, x in flatten(tree)[0]}


RUN_CONFIGS = {"default": {}, "serve": {"serve_rate": 0.3},
               "crash": {"crash_rate": 0.1},
               "serve_crash": {"serve_rate": 0.3, "crash_rate": 0.1}}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(RUN_CONFIGS))
def test_runner_matches_jax(name, policy):
    """Per-op outcomes, final statuses and step counts (the fingerprint),
    virtual time, final SimTenant states bit for bit, and the serving
    tenants' token streams, seeds 0-5."""
    for seed in range(6):
        kw = dict(seed=seed, policy=policy, **RUN_CONFIGS[name])
        jr = jsim.ScenarioRunner(jsim.ScenarioConfig(**kw))
        want = jr.run()
        tr = tsim.ScenarioRunner(tsim.ScenarioConfig(**kw), device="cpu")
        got = tr.run()
        assert got.fingerprint() == want.fingerprint(), seed
        assert (got.num_ok, got.num_rejected) == (want.num_ok,
                                                  want.num_rejected)
        assert got.virtual_seconds == want.virtual_seconds
        assert [r.status for r in got.ops] == [r.status for r in want.ops]
        assert len(got.reconf_timings) == len(want.reconf_timings)
        assert sorted(tr.tenants) == sorted(jr.tenants)
        for tid, jt in jr.tenants.items():
            tt = tr.tenants[tid]
            assert (tt.status, tt.steps_done) == (jt.status, jt.steps_done)
            if hasattr(jt, "requests"):
                assert ([(r.rid, r.out, r.done) for r in tt.requests]
                        == [(r.rid, r.out, r.done) for r in jt.requests])
            elif jt.status == "running":
                w, g = _leaves(jt.export_state()), _leaves(tt.export_state())
                assert sorted(g) == sorted(w)
                for path in w:
                    assert g[path].dtype == w[path].dtype == np.float32
                    assert np.array_equal(g[path].view(np.uint32),
                                          w[path].view(np.uint32)), path


@pytest.mark.parametrize("point", tsim.PORTED_POINTS)
def test_crash_case_matches_jax(point):
    for seed in (0, 1):
        for policy in POLICIES:
            want = jax_crash_case(point, seed, policy)
            got = tsim.run_crash_case(point, seed, policy, device="cpu")
            assert got == want


def test_crash_matrix_default_is_the_ported_points():
    out = tsim.crash_matrix(seeds=(0,), policies=("best_fit",),
                            device="cpu")
    assert out["summary"]["num_cases"] == 15
    assert out["summary"]["num_failures"] == 0
    assert sorted(c["point"] for c in out["cases"]) == sorted(
        tsim.PORTED_POINTS)


# ---------------------------------------------------------------------------
# checker sensitivity: a vacuous checker would pass everything
# ---------------------------------------------------------------------------
def _system(tmp_path, tenant):
    pool = DevicePool(devices=tuple(f"d{i}" for i in range(8)))
    mgr = SVFFManager(pool, workdir=str(tmp_path),
                      staging=StagingEngine(num_queues=1),
                      scheduler="first_fit")
    mgr.init(num_vfs=2, tenants=[tenant], devices_per_vf=2)
    return mgr


def test_checker_detects_a_flipped_bit(tmp_path):
    """I4: one flipped bit in one leaf, after a pause round trip."""
    tn = tsim.SimTenant("vm0", seed=3, device="cpu")
    mgr = _system(tmp_path, tn)
    tn.run_steps(2)
    mgr.pause(tn)
    mgr.unpause(tn)
    tsim.check_invariants(mgr)
    leaf = tn.export_state()["opt"]["mu"]
    leaf.view(torch.int32)[5] ^= 1
    with pytest.raises(tsim.InvariantViolation, match="I4 vm0: leaf 0"):
        tsim.check_invariants(mgr)


def test_runner_checks_state_placement():
    """A running tenant's state leaf off the runner's device raises."""
    runner = tsim.ScenarioRunner(tsim.ScenarioConfig(seed=0), device="cpu")
    runner.run()
    tid, tn = next((t, x) for t, x in sorted(runner.tenants.items())
                   if x.status == "running" and t.startswith("vm"))
    runner._check_placement()
    state = tn.export_state()
    state["opt"]["mu"] = state["opt"]["mu"].to("meta")
    with pytest.raises(tsim.InvariantViolation,
                       match=f"{tid}: a state leaf is not a tensor on cpu"):
        runner._check_placement()


def _serving(tmp_path):
    tn = tsim.SimServeTenant("sv0", seed=2, device="cpu")
    mgr = _system(tmp_path, tn)
    tn.submit_burst(6)
    tn.run_steps(2)                        # pages held, sharing live
    assert tn.alloc.pages_in_use > 0
    tsim.check_invariants(mgr)
    return mgr, tn


def test_checker_detects_a_table_row_off_its_chain(tmp_path):
    """I12: a block-table row that no longer spells its request's chain."""
    mgr, tn = _serving(tmp_path)
    slot = next(s for s, r in enumerate(tn.active) if r is not None)
    tn.tables[slot, 0] = (tn.tables[slot, 0] % (tn.num_pages - 1)) + 1
    with pytest.raises(tsim.InvariantViolation, match="I12"):
        tsim.check_invariants(mgr)


def test_checker_detects_a_corrupted_page(tmp_path):
    """I10: a page cell corrupted while paused changes the tokens the
    engine goes on to emit."""
    mgr, tn = _serving(tmp_path)
    mgr.pause(tn)
    snap = mgr.snapshots["sv0"]
    slot = next(s for s, r in enumerate(tn.active) if r is not None)
    page = int(snap.payload["tables"][slot, 0])
    snap.payload["pages"][page] += 1
    mgr.unpause(tn)
    with pytest.raises(tsim.InvariantViolation, match="I10"):
        for _ in range(8):
            tn.run_steps(1)
            tsim.check_invariants(mgr)


def test_serve_tenant_pause_live_round_trip(tmp_path):
    """The serving tenant steps between pre-copy rounds; its arrays come
    back through the staging engine, and every request drains to its
    oracle (I10, I12, I13 after each step)."""
    mgr, tn = _serving(tmp_path)
    mgr.pause_live(tn, rounds=2, step_fn=lambda: tn.run_steps(1))
    assert all(t is None for t in (tn.pages, tn.tables, tn.pos, tn.last))
    mgr.unpause(tn)
    for _ in range(60):
        tn.run_steps(1)
        tsim.check_invariants(mgr)
        if not tn.queue and all(r is None for r in tn.active):
            break
    assert all(r.done for r in tn.requests)
    assert all(r.out == tsim.SimServeTenant.expected_output(2, r.rid)
               for r in tn.requests)


# ---------------------------------------------------------------------------
# refusals, each naming its ROADMAP item
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rate,item", [("reshape_rate", "item 13")])
def test_runner_refuses_unported_rates(rate, item):
    cfg = tsim.ScenarioConfig(seed=0, serve_rate=0.3, **{rate: 0.2})
    with pytest.raises(NotImplementedError, match=item):
        tsim.ScenarioRunner(cfg, device="cpu")


ELASTIC_CONFIGS = {"autoscale": {"autoscale_rate": 0.2},
                   "migrate": {"migrate_rate": 0.25},
                   "both": {"autoscale_rate": 0.1, "migrate_rate": 0.25},
                   "both_crash": {"autoscale_rate": 0.1,
                                  "migrate_rate": 0.25, "crash_rate": 0.1}}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(ELASTIC_CONFIGS))
def test_runner_elastic_rates_match_jax(name, policy):
    """The autoscale and migrate_request ops: per-op outcomes, virtual
    time, autoscaler history, migrations and the serving tenants' token
    streams equal the JAX runner's, seeds 0-3, with I11 and I13 checked
    after every op."""
    for seed in range(4):
        kw = dict(seed=seed, policy=policy, serve_rate=0.45,
                  **ELASTIC_CONFIGS[name])
        jr = jsim.ScenarioRunner(jsim.ScenarioConfig(**kw))
        want = jr.run()
        tr = tsim.ScenarioRunner(tsim.ScenarioConfig(**kw), device="cpu")
        got = tr.run()
        assert got.fingerprint() == want.fingerprint(), seed
        assert got.virtual_seconds == want.virtual_seconds
        assert ([(a.kind, a.victim, a.target) for a in
                 tr.autoscaler.history]
                == [(a.kind, a.victim, a.target) for a in
                    jr.autoscaler.history])
        assert sorted(tr.tenants) == sorted(jr.tenants)
        for tid, jt in jr.tenants.items():
            tt = tr.tenants[tid]
            assert (tt.status, tt.steps_done) == (jt.status, jt.steps_done)
            if hasattr(jt, "requests"):
                assert ([(r.rid, r.out, r.done) for r in tt.requests]
                        == [(r.rid, r.out, r.done) for r in jt.requests])
                assert ((tt.migrations_in, tt.migrations_out,
                         tt.migration_stall_ticks)
                        == (jt.migrations_in, jt.migrations_out,
                            jt.migration_stall_ticks))


@pytest.mark.parametrize("point", sorted(
    set(tsim.CRASH_POINTS) - set(tsim.PORTED_POINTS)))
def test_unported_crash_points_refused(point):
    with pytest.raises(NotImplementedError, match="item 13"):
        tsim.run_crash_case(point, 0, device="cpu")


def test_serve_tenant_migration_methods_refused(tmp_path):
    """The serving sim tenant's migration protocol, step by step beside
    the JAX tenant's: peek, extract (a frozen slot, the chain's cells),
    a target-side no-op abort, a thawed slot, then a committed hand-off; ownership, counters and every emitted token
    equal, and both engines' requests finish on the oracle's stream."""
    def run(sim, kw):
        a = sim.SimServeTenant("sv0", seed=4, **kw)
        b = sim.SimServeTenant("sv1", seed=4, **kw)
        core = (DevicePool, SVFFManager, StagingEngine) if sim is tsim \
            else (JPool, JManager, JStaging)
        pool = core[0](devices=tuple(f"d{i}" for i in range(8)), max_vfs=4)
        mgr = core[1](pool, workdir=str(tmp_path / sim.__name__),
                      staging=core[2](num_queues=1), scheduler="first_fit")
        mgr.init(2, [a, b], devices_per_vf=2)
        a.submit_burst(4)
        obs = []
        for _ in range(3):
            a.run_steps(1)
            b.run_steps(1)
        rid = a.peek_migratable()
        obs.append((rid, a.owns_request(rid), b.owns_request(rid)))
        payload = a.extract_request(rid)
        cells = np.asarray(payload["state"]["cells"].cpu()
                           if sim is tsim else payload["state"]["cells"])
        obs.append((payload["chain_len"], payload["pos"], payload["last"],
                    cells.tolist(), a.peek_migratable(rid)))
        a.run_steps(1)                              # the frozen slot stalls
        obs.append(a.migration_stall_ticks)
        b.abort_incoming(rid)                       # no-op: never admitted
        obs.append(a.abort_migration(rid))
        res = mgr.migrate_request(a, b, rid)
        obs.append((res["rid"], res["blocks"], a.owns_request(rid),
                    b.owns_request(rid), a.migrations_out, b.migrations_in,
                    b.shared_hits))
        for _ in range(12):
            a.run_steps(1)
            b.run_steps(1)
        sim.check_invariants(mgr)
        obs.append([(r.rid, r.out, r.done) for r in a.requests + b.requests])
        return obs

    got = run(tsim, {"device": "cpu"})
    assert got == run(jsim, {})
    assert got[0][1:] == (True, False) and got[2] == 1
    for rid, out, done in got[-1]:
        assert done and out == tsim.SimServeTenant.expected_output(4, rid)



def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for make in (lambda: tsim.ScenarioRunner(tsim.ScenarioConfig()),
                 lambda: tsim.SimTenant("vm0"),
                 lambda: tsim.run_crash_case("after_suspend", 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# ---------------------------------------------------------------------------
# the benchmarks print the JAX benchmarks' report keys
# ---------------------------------------------------------------------------
def _bench(name):
    return json.loads((ROOT / f"BENCH_{name}.json").read_text())


def test_scenario_sweep_bench(capsys, tmp_path):
    out = tmp_path / "s.json"
    assert tsweep.main(["--device", "cpu", "--scenarios", "2", "--out",
                        str(out)]) == 0
    report, want = json.loads(out.read_text()), _bench("scenario_sweep")
    assert set(want) == set(report)
    assert set(want["config"]) <= set(report["config"])
    assert sorted(report["policies"]) == sorted(want["policies"])
    for row in report["policies"].values():
        assert set(row) == set(next(iter(want["policies"].values())))
        assert row["ops"] == 48 and row["ops_per_sec"] > 0
    assert "ops/s" in capsys.readouterr().out


def test_crash_matrix_bench(tmp_path):
    out = tmp_path / "c.json"
    assert tcrash.main(["--device", "cpu", "--seeds", "1", "--points",
                        "after_suspend", "qmp_timeout", "--out",
                        str(out)]) == 0
    report, want = json.loads(out.read_text()), _bench("crash_matrix")
    assert set(report) == set(want)
    assert set(want["protocol"]) <= set(report["protocol"])
    assert set(report["summary"]) == set(want["summary"])
    assert all(set(r) == set(want["matrix"][0]) for r in report["matrix"])
    assert report["summary"]["all_green"]
    assert report["summary"]["num_cases"] == 6


def test_pause_path_bench_smoke(capsys):
    """The smoke-size state on the CPU (the int8 rows through the plain
    versions of the staging kernels): the JAX rows' keys, bit-equal
    restores where uncompressed, int8 within its bound, an unchanged
    incremental save moving nothing, a live pause stalling less than a
    stop-the-world one moves."""
    assert tpause.main(["--device", "cpu", "--smoke", "--repeats",
                        "1"]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    want = {r["name"]: set(r) for r in _bench("pause_path")}
    assert [r["name"] for r in rows] == list(want)
    by = {r["name"]: r for r in rows}
    for name, keys in want.items():
        assert keys <= set(by[name]), name
    for r in rows:
        if "int8" in r["name"]:
            assert 0 < r["max_rel_err"] and r["int8_bound_share"] <= 1
            assert r["bytes_moved"] < 0.4 * r["logical_bytes"]
        else:
            assert r["max_rel_err"] == 0.0
    assert by["incremental_unchanged"]["bytes_moved"] == 0
    assert (by["pause_live_precopy"]["stop_bytes_moved"]
            < by["pause_stop_world"]["stop_bytes_moved"])
