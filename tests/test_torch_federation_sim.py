"""The port's federation scenario plane (``repro_torch.sim.federation``,
``check_federation``) against the JAX package's, on the CPU.

* ``generate_fed_scenario`` emits the JAX op tuples for several seeds and
  configs, zero rates and fault rates; zero rates draw no fault op;
* ``run_network_fault_case`` returns the JAX outcome dict for every
  window of ``NETWORK_FAULTS`` x seeds 0-2 (the dicts hold no path and no
  wall time), with the partition-during-migrate regression; a chaos-
  marked matrix over seeds 0-4, and the full acceptance matrix behind
  the JAX test's switch and markers;
* ``run_fed_scenario`` at the JAX fault-soup rates, seeds 0-3: the
  fingerprint, the counters and every per-op row equal JAX's;
* the interleaved-recovery property (I16): after a deferred cross-host
  migration, any interleaving of per-host recoveries keeps the JAX
  fingerprint, on both packages;
* ``check_federation`` bites: a dual-served rid, a stranded freeze and a
  fence from nowhere each raise.

The sim tenants' state is on the CPU here (``device="cpu"``); the card
runs the same cells in ``chip_smoke.py``.
"""
import dataclasses
import os
import shutil
import tempfile

import hypothesis.strategies as st
import pytest
from hypothesis import given, settings

import repro.sim.federation as jfed
import repro_torch.sim.federation as tfed
from repro.sim.tenant import SimServeTenant as JSimServe
from repro_torch.core import HostUnreachableError
from repro_torch.sim import InvariantViolation, check_federation
from repro_torch.sim.tenant import SimServeTenant as TSimServe

HSET = settings(max_examples=15, deadline=None)
SOUP = dict(num_ops=35, partition_rate=0.15, crash_rate=0.1,
            handoff_rate=0.05, migrate_rate=0.15, autoscale_rate=0.1)
GEN_CONFIGS = {
    "zero": {},
    "soup": SOUP,
    "partition": {"partition_rate": 0.3, "num_hosts": 4},
    "migrate": {"migrate_rate": 0.4, "num_ops": 60},
    "crash_handoff": {"crash_rate": 0.2, "handoff_rate": 0.2,
                      "policy": "best_fit"},
}


def _astuples(ops):
    return [dataclasses.astuple(o) for o in ops]


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(GEN_CONFIGS))
def test_generate_fed_scenario_matches_jax(name):
    kw = GEN_CONFIGS[name]
    for seed in range(20):
        want = jfed.generate_fed_scenario(jfed.FedScenarioConfig(seed=seed,
                                                                 **kw))
        got = tfed.generate_fed_scenario(tfed.FedScenarioConfig(seed=seed,
                                                                **kw))
        assert _astuples(got) == _astuples(want), seed
    assert ([(f.name, f.default)
             for f in dataclasses.fields(tfed.FedScenarioConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jfed.FedScenarioConfig)])
    assert tfed.FED_OP_KINDS == jfed.FED_OP_KINDS


def test_fed_scenario_zero_rates_have_no_faults():
    for seed in range(10):
        ops = tfed.generate_fed_scenario(tfed.FedScenarioConfig(seed=seed,
                                                                num_ops=60))
        assert {op.kind for op in ops} <= {"init", "submit", "step", "beat"}


def test_fed_scenario_deterministic_and_on_its_device():
    cfg = tfed.FedScenarioConfig(seed=9, num_ops=30)
    assert tfed.generate_fed_scenario(cfg) == tfed.generate_fed_scenario(cfg)
    runner = tfed.FedRunner(cfg, device="cpu")
    a = runner.run()
    b = tfed.run_fed_scenario(cfg, device="cpu")
    assert a == b
    assert all(x.device.type == "cpu" for h in runner.hosts
               for tn in h.serve_targets()
               for x in tn.export_state().values())


# ---------------------------------------------------------------------------
# federation scenarios
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_fed_scenario_fault_soup_matches_jax(seed):
    """The JAX fault soup on both packages: fingerprint, counters, epoch
    and every per-op row equal (I1-I15 after every op, I16 on every host
    crash, inside each runner)."""
    want = jfed.run_fed_scenario(jfed.FedScenarioConfig(seed=seed, **SOUP))
    got = tfed.run_fed_scenario(tfed.FedScenarioConfig(seed=seed, **SOUP),
                                device="cpu")
    assert got == want
    assert got["submitted"] >= 1


# ---------------------------------------------------------------------------
# the network-fault matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", sorted(jfed.NETWORK_FAULTS))
def test_network_fault_window_matches_jax(window):
    assert tfed.NETWORK_FAULTS[window] == tfed.NetFaultSpec(
        **dataclasses.asdict(jfed.NETWORK_FAULTS[window]))
    for seed in range(3):
        want = jfed.run_network_fault_case(window, seed)
        got = tfed.run_network_fault_case(window, seed, device="cpu")
        assert got == want and got["ok"], (seed, got, want)


def test_partition_during_migrate_regression():
    """The in-doubt distributed commit: the partition lands AFTER the
    remote admit, the journal entry defers, and recovery rolls FORWARD
    (dst serves, src frees exactly once) — rolling back would dual-serve
    the request (I15)."""
    res = tfed.run_network_fault_case("fed_migrate_after_admit", 0,
                                      device="cpu")
    assert res["ok"] and res["outcome"] == "defer_forward"
    assert res == jfed.run_network_fault_case("fed_migrate_after_admit", 0)


@pytest.mark.chaos
def test_network_fault_matrix_fast():
    out = tfed.network_fault_matrix(seeds=range(5), device="cpu")
    assert out["summary"]["num_failures"] == 0
    assert out["summary"]["num_cases"] == len(tfed.NETWORK_FAULTS) * 5


@pytest.mark.chaos
@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("SVFF_CHAOS_FULL") != "1",
                    reason="full network-fault matrix runs on main "
                           "(CI chaos job sets SVFF_CHAOS_FULL=1)")
def test_network_fault_matrix_full():
    """Acceptance: every window x >= 10 seeds, zero failures."""
    out = tfed.network_fault_matrix(seeds=range(10), device="cpu")
    assert out["summary"]["num_failures"] == 0
    assert out["summary"]["num_cases"] == len(tfed.NETWORK_FAULTS) * 10


# ---------------------------------------------------------------------------
# property: interleaved journal replay reconciles to one fingerprint
# ---------------------------------------------------------------------------
def _interleaved(fed, sim_serve, unreachable, build, wd, order, seed):
    cell = build(seed, wd)
    co, fabric = cell["coordinator"], cell["fabric"]
    subs = [co.submit(seed=seed) for _ in range(3)]
    res = max(subs, key=lambda r: sim_serve.make_max_new(seed, r["rid"]))
    src = next(h for h in cell["hosts"] if h.host_id == res["host"])
    for tn in src.serve_targets():
        tn.run_steps(1)
    dst_id = "h1" if res["host"] != "h1" else "h2"
    fabric.arm("fed_migrate_after_admit",
               [co.node_id] + [h.host_id for h in cell["hosts"]
                               if h.host_id != dst_id], [dst_id])
    with pytest.raises(unreachable):
        co.migrate_request(res["host"], dst_id, res["rid"])
    fabric.heal()
    co.recover()
    want = fed.federation_fingerprint(cell["hosts"], co)
    seen = [want]
    for hid in order:
        co.recover([hid])
        seen.append(fed.federation_fingerprint(cell["hosts"], co))
    return seen


@given(order=st.sampled_from([("h0", "h1"), ("h1", "h0"),
                              ("h0", "h1", "h0"), ("h1", "h1", "h0")]),
       seed=st.integers(0, 7))
@HSET
def test_interleaved_recovery_fingerprint(order, seed):
    """Two hosts carry journal entries (one a DEFERRED cross-host
    migrate); replaying their recoveries in ANY interleaving — including
    repeats — reconciles the federation to the same fingerprint (I16),
    the JAX package's on the same order and seed."""
    from repro.core import HostUnreachableError as JUnreachable
    wd = tempfile.mkdtemp(prefix="svff_fed_prop_")
    try:
        want = _interleaved(
            jfed, JSimServe, JUnreachable,
            lambda s, w: jfed.build_fed_cell(s, workdir=w),
            os.path.join(wd, "jax"), order, seed)
        got = _interleaved(
            tfed, TSimServe, HostUnreachableError,
            lambda s, w: tfed.build_fed_cell(s, workdir=w, device="cpu"),
            os.path.join(wd, "port"), order, seed)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    assert got == want
    assert len(set(got)) == 1


# ---------------------------------------------------------------------------
# the checker bites
# ---------------------------------------------------------------------------
def test_check_federation_bites(tmp_path):
    """A rid served on two hosts, a slot frozen with no pending journaled
    migrate entry, and a host fence above every coordinator's epoch each
    raise ``InvariantViolation`` (I15)."""
    cell = tfed.build_fed_cell(0, workdir=str(tmp_path), device="cpu")
    co, hosts = cell["coordinator"], cell["hosts"]
    check_federation(hosts, [co])
    res = co.submit(seed=1)
    other = next(h for h in hosts if h.host_id != res["host"])
    dup = other.serve_targets()[0].submit_request(res["rid"], seed=1)
    with pytest.raises(InvariantViolation, match="dual-serve"):
        check_federation(hosts, [co])
    other.serve_targets()[0].queue.remove(dup)
    check_federation(hosts, [co])
    subs = [res] + [co.submit(seed=1) for _ in range(2)]
    res = max(subs, key=lambda r: TSimServe.make_max_new(1, r["rid"]))
    src = next(h for h in hosts if h.host_id == res["host"])
    eng = src.owner_engine(res["rid"])
    for tn in src.serve_targets():
        tn.run_steps(1)
    assert eng.peek_migratable(res["rid"]) == res["rid"]
    eng.extract_request(res["rid"])              # frozen, no journal entry
    with pytest.raises(InvariantViolation, match="stranded freeze"):
        check_federation(hosts, [co])
    eng.abort_migration(res["rid"])
    hosts[0].fence_epoch = co.epoch + 1
    with pytest.raises(InvariantViolation, match="fence from nowhere"):
        check_federation(hosts, [co])
