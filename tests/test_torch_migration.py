"""Request live migration, engine recovery and chunked prefill on the port,
held against the JAX package on the CPU (mirrors ``tests/test_migration.py``
case for case, plus the engine parts the fleet stands on).

Both packages' fleets get the same params (the JAX init, converted
through ``interop``), fp32 compute and the same numpy requests. Each
scenario runs on both sides and what it observes must be equal: token
streams, the journal's (op, tenant, vf_id, status) sequence, migration
results, the fleet telemetry's migration counters, refcounts and typed
refusals. On top of the JAX cases:

* chunked-prefill logits within the fp32 tolerance of the prefill parity
  test (``test_torch_model``), including a first chunk at offset 0 whose
  staging cache is longer than the chunk — which must take the plain
  attention, as JAX's traced offset does;
* a hybrid-twin request migrating with its recurrent slot state;
* the int8 KV scale of the JAX engine (``jax.jit(kv_quantize)``) bit for
  bit on a seeded (4096, 8, 128) draw, with the dequant -> requant
  composition, and a migrated int8 request's target pages equal to the
  plain requantization of the source's dequantized pages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as jsim
import repro_torch.sim as tsim
from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.core import ManagerError as JManagerError
from repro.core.autoscaler import (AutoscaleAction as JAction,
                                   AutoscaleConfig as JConfig,
                                   EngineStats as JStats,
                                   TelemetrySnapshot as JSnap,
                                   justify_action as jjustify)
from repro.core.manager import SVFFManager as JManager
from repro.core.pool import DevicePool as JPool
from repro.core.staging import StagingEngine as JStaging
from repro.models.model import build_model as jax_model
from repro.serve import paged as jpaged
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.fleet import ServeFleet as JFleet
from repro.serve.paged import CacheExhausted as JExhausted
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.core import DevicePool as TPool
from repro_torch.core import StagingEngine as TStaging
from repro_torch.core.autoscaler import (AutoscaleAction as TAction,
                                         AutoscaleConfig as TConfig,
                                         EngineStats as TStats,
                                         TelemetrySnapshot as TSnap,
                                         justify_action as tjustify)
from repro_torch.core.errors import ManagerError as TManagerError
from repro_torch.core.manager import SVFFManager as TManager
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.models.model import build_model as torch_model
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.fleet import ServeFleet as TFleet
from repro_torch.serve.paged import CacheExhausted as TExhausted

ARCH = "qwen3-0.6b"
HYBRID = "jamba-1.5-large-398b-1p-dense"
#: the fp32 tolerance of the prefill parity test (test_torch_model.TOL)
TOL32 = 1e-4
JAX, PORT = "jax", "port"
MIG_KEYS = ("migrations_attempted", "migrations_completed",
            "migrations_aborted", "migration_blocks",
            "migration_stall_ticks")


@pytest.fixture(scope="module")
def setup():
    jrun = jax_run_config(ARCH, "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"))
    trun = torch_run_config(ARCH, "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"))
    jp = jax_model(jrun).init(jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return {JAX: (jrun, jp), PORT: (trun, tp)}


@pytest.fixture(scope="module")
def hybrid():
    jrun = jax_run_config("jamba-1.5-large-398b", "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"))
    jrun = dataclasses.replace(
        jrun, model=dataclasses.replace(jrun.model, moe=None))
    trun = torch_run_config(HYBRID, "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"))
    jp = jax_model(jrun).init(jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return {JAX: (jrun, jp), PORT: (trun, tp)}


def _fleet(setup, side, workdir, **kw):
    run, params = setup[side]
    kw.setdefault("num_engines", 2)
    kw.setdefault("num_devices", 4)
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("page_size", 8)
    if side == JAX:
        return JFleet(run, params, paged=True, workdir=str(workdir), **kw)
    return TFleet(run, params, device="cpu", workdir=str(workdir), **kw)


def _req(side, rid, prompt, new, **kw):
    cls = JRequest if side == JAX else TRequest
    return cls(rid=rid, prompt=np.array(prompt), max_new_tokens=new, **kw)


def _sampling(rid):
    """Greedy for even rids, temperature 0.8 (top-k 16 on every fourth)
    for odd ones: the migrated stream goes through the sampler's
    (seed, rid, position) counter keys on its new engine."""
    if rid % 2 == 0:
        return {}
    return {"temperature": 0.8, "top_k": 16 if rid % 4 == 1 else 0,
            "seed": 3 + rid}


def _reference(setup, side, specs, **engine_kw):
    """Token oracle: the same requests served by one undisturbed engine."""
    run, params = setup[side]
    engine_kw.setdefault("slots", max(2, len(specs)))
    engine_kw.setdefault("max_len", 48)
    engine_kw.setdefault("page_size", 8)
    if side == JAX:
        eng = JEngine(run, params, paged=True, **engine_kw)
    else:
        eng = TEngine(run, params, device="cpu", paged=True, **engine_kw)
    reqs = [_req(side, rid, p, n, **_sampling(rid)) for rid, p, n in specs]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_idle().drained
    return {r.rid: list(r.out) for r in reqs}


def _journal(mgr):
    return [(e["op"], e["tenant"], e["vf_id"], e["status"])
            for e in mgr.journal.entries()]


def _both(fn, *args):
    """Run a scenario on both packages; the observations must be equal.
    Returns the port's."""
    want, got = fn(JAX, *args), fn(PORT, *args)
    assert got == want
    return got


# ===========================================================================
# mid-decode migration: token identity + telemetry
# ===========================================================================
def test_mid_decode_migration_is_token_identical(setup, tmp_path):
    specs = [(0, (np.arange(6) * 5 + 2) % 100, 6),
             (1, (np.arange(9) * 3) % 100, 5)]

    def run(side):
        fleet = _fleet(setup, side, tmp_path / side)
        reqs = [_req(side, rid, p, n, **_sampling(rid))
                for rid, p, n in specs]
        placed = [fleet.submit(r) for r in reqs]
        for _ in range(2):
            fleet.step()
        victim = reqs[0]
        assert victim.out and not victim.done      # genuinely mid-decode
        res = fleet.migrate_request("serve0", "serve1", victim.rid)
        obs = {"placed": placed,
               "res": (res["rid"], res["src"], res["dst"], res["blocks"]),
               "owns": (fleet.tenants["serve1"].owns_request(victim.rid),
                        fleet.tenants["serve0"].owns_request(victim.rid)),
               "migrating": dict(fleet.tenants["serve0"].engine._migrating),
               "pending": fleet.mgr.query()["journal_pending"]}
        done = fleet.drain()
        desc = fleet.telemetry.describe()["serve0"]
        snap = {e.tid: (e.migrations_completed, e.migration_blocks_shipped)
                for e in fleet.telemetry_snapshot().engines}
        return dict(obs, done=sorted(r.rid for r in done),
                    outs={r.rid: list(r.out) for r in reqs},
                    errors=[r.error for r in reqs],
                    journal=_journal(fleet.mgr),
                    desc={k: desc[k] for k in MIG_KEYS}, snap=snap)

    got = _both(run)
    assert got["placed"] == ["serve0", "serve1"]
    assert got["res"][0] == 0 and got["res"][3] >= 1   # pages shipped
    assert got["owns"] == (True, False) and got["migrating"] == {}
    assert got["pending"] == 0 and got["done"] == [0, 1]
    assert got["outs"] == _reference(setup, PORT, specs)
    assert got["desc"]["migrations_attempted"] == 1
    assert got["desc"]["migrations_completed"] == 1
    assert got["desc"]["migrations_aborted"] == 0
    assert got["desc"]["migration_blocks"] == got["res"][3]
    assert got["snap"]["serve0"] == (1, got["res"][3])
    assert [e for e in got["journal"] if e[0] == "migrate_request"] == [
        ("migrate_request", "serve0", got["journal"][0][2], "committed")]


def test_aborted_migration_is_side_effect_free_and_retryable(setup,
                                                              tmp_path):
    """A target-side CacheExhausted leaves the Request untouched (no
    done/error flags, tokens intact, still decoding on the source), so the
    SAME migration retries later and completes token-identically."""
    specs = [(0, (np.arange(8) * 7 + 1) % 100, 8)]

    def run(side):
        exhausted = JExhausted if side == JAX else TExhausted
        # 5 pages (page 0 reserved -> 4 usable) per engine: two 2-page
        # residents fill serve1's pool AND both its slots
        fleet = _fleet(setup, side, tmp_path / side, num_pages=5)
        victim = _req(side, 0, specs[0][1], 8)
        fleet.tenants["serve0"].engine.submit(victim)
        for i in range(2):
            fleet.tenants["serve1"].engine.submit(
                _req(side, 10 + i, (np.arange(12) * (i + 3)) % 100, 6))
        for _ in range(2):
            fleet.step()
        before = list(victim.out)
        with pytest.raises(exhausted):
            fleet.mgr.migrate_request(fleet.tenants["serve0"],
                                      fleet.tenants["serve1"], victim.rid)
        clean = (victim.done, victim.error, list(victim.out) == before,
                 fleet.tenants["serve0"].owns_request(victim.rid),
                 fleet.tenants["serve1"].owns_request(victim.rid),
                 dict(fleet.tenants["serve0"].engine._migrating),
                 fleet.mgr.query()["journal_pending"])
        wrapped = fleet.migrate_request("serve0", "serve1", victim.rid)
        counters = (fleet.telemetry.migrations_aborted["serve0"],
                    fleet.telemetry.migrations_completed["serve0"])
        fleet.tenants["serve1"].engine.run_until_idle()
        retry = fleet.migrate_request("serve0", "serve1", victim.rid)
        owned = fleet.tenants["serve1"].owns_request(victim.rid)
        fleet.drain()
        return {"before": before, "clean": clean, "wrapped": wrapped,
                "counters": counters, "retry_blocks": retry["blocks"],
                "owned": owned, "out": list(victim.out),
                "done": (victim.done, victim.error),
                "journal": _journal(fleet.mgr)}

    got = _both(run)
    assert got["before"]
    assert got["clean"] == (False, None, True, True, False, {}, 0)
    assert got["wrapped"] is None and got["counters"] == (3, 0)
    assert got["owned"] and got["done"] == (True, None)
    assert got["out"] == _reference(setup, PORT, specs)[0]


# ===========================================================================
# prefix sharing / CoW across migration
# ===========================================================================
def test_migrating_prefix_shared_requests_reshare_on_target(setup,
                                                            tmp_path):
    base = (np.arange(16) * 3 + 1) % 100           # two FULL shared pages
    pa = np.concatenate([base, (np.arange(4) * 7) % 100])
    pb = np.concatenate([base, (np.arange(4) * 11 + 5) % 100])
    specs = [(0, pa, 5), (1, pb, 5)]

    def run(side):
        fleet = _fleet(setup, side, tmp_path / side, share_prefix=True)
        ra, rb = (_req(side, rid, p, n, **_sampling(rid))
                  for rid, p, n in specs)
        src = fleet.tenants["serve0"].engine
        dst = fleet.tenants["serve1"].engine
        src.submit(ra)
        src.submit(rb)
        for _ in range(2):
            fleet.step()
        head = src.alloc.pages_of(ra.rid)[0]
        seen = [src.alloc.refcount(head)]
        seen.append(fleet.migrate_request("serve0", "serve1",
                                          rb.rid)["blocks"])
        seen.append(src.alloc.refcount(head))
        src.alloc.check_invariants()
        dst.alloc.check_invariants()
        seen.append(fleet.migrate_request("serve0", "serve1",
                                          ra.rid)["blocks"])
        seen += [dst.alloc.shared_count(ra.rid),
                 dst.alloc.refcount(dst.alloc.pages_of(ra.rid)[0]),
                 dst.stats["shared_page_hits"]]
        src.alloc.check_invariants()
        dst.alloc.check_invariants()
        fleet.drain()
        return {"seen": seen, "outs": [list(r.out) for r in (ra, rb)],
                "errors": [r.error for r in (ra, rb)]}

    got = _both(run)
    refs, _, refs_after, _, shared, head_refs, _ = got["seen"]
    assert refs == 2 and refs_after == 1           # really shared, then not
    assert shared == 2 and head_refs == 2          # re-shared on the target
    want = _reference(setup, PORT, specs, share_prefix=True)
    assert got["outs"] == [want[0], want[1]]


# ===========================================================================
# scale_in under load drains by migration
# ===========================================================================
def test_scale_in_under_load_migrates_work_to_siblings(setup, tmp_path):
    rng = np.random.default_rng(17)
    specs = [(i, rng.integers(0, 100, int(rng.integers(4, 9))), 6)
             for i in range(4)]

    def run(side):
        fleet = _fleet(setup, side, tmp_path / side, slots=4)
        reqs = [_req(side, rid, p, n, **_sampling(rid))
                for rid, p, n in specs]
        for r in reqs:
            fleet.submit(r)
        for _ in range(2):
            fleet.step()
        busy = fleet.tenants["serve1"]
        load = busy.load
        fleet.scale_in("serve1")
        obs = (load, busy.status,
               [fleet.tenants["serve0"].owns_request(r.rid) for r in reqs],
               fleet.mgr.query()["journal_pending"])
        done = fleet.drain()
        desc = fleet.telemetry.describe()["serve1"]
        return {"obs": obs, "done": sorted(r.rid for r in done),
                "outs": {r.rid: list(r.out) for r in reqs},
                "journal": _journal(fleet.mgr),
                "desc": {k: desc[k] for k in MIG_KEYS}}

    got = _both(run)
    assert got["obs"][0] > 0 and got["obs"][1] == "detached"
    assert all(got["obs"][2]) and got["obs"][3] == 0
    assert got["done"] == [0, 1, 2, 3]
    assert got["desc"]["migrations_completed"] >= 1
    assert got["outs"] == _reference(setup, PORT, specs)


def test_scale_in_refuses_typed_when_no_sibling_has_capacity(setup,
                                                             tmp_path):
    def run(side):
        err = JManagerError if side == JAX else TManagerError
        fleet = _fleet(setup, side, tmp_path / side, num_engines=1)
        req = _req(side, 0, np.arange(6) % 100, 6)
        fleet.submit(req)
        fleet.step()
        with pytest.raises(err, match="no running sibling") as e:
            fleet.scale_in("serve0")
        owns = fleet.tenants["serve0"].owns_request(req.rid)
        fleet.drain()
        return {"msg": str(e.value), "owns": owns,
                "done": (req.done, req.error), "out": list(req.out)}

    got = _both(run)
    assert got["owns"] and got["done"] == (True, None)


# ===========================================================================
# engine crash: live requests re-home onto siblings
# ===========================================================================
def test_engine_crash_rehomes_live_requests_zero_loss(setup, tmp_path):
    rng = np.random.default_rng(23)
    specs = [(i, rng.integers(0, 100, int(rng.integers(4, 8))), 5)
             for i in range(4)]

    def run(side):
        fleet = _fleet(setup, side, tmp_path / side, slots=4)
        reqs = [_req(side, rid, p, n, **_sampling(rid))
                for rid, p, n in specs]
        for r in reqs:
            fleet.submit(r)
        for _ in range(2):
            fleet.step()
        crashed = [r.rid for r in reqs
                   if fleet.tenants["serve0"].owns_request(r.rid)]
        out = fleet.recover_engine("serve0")
        after = (fleet.tenants["serve0"].load,
                 fleet.tenants["serve0"].status,
                 fleet.tenants["serve0"].engine._cache is None)
        done = fleet.drain()
        return {"crashed": crashed, "rehomed": out["rehomed"],
                "after": after, "done": sorted(r.rid for r in done),
                "outs": {r.rid: list(r.out) for r in reqs},
                "errors": [r.error for r in reqs]}

    got = _both(run)
    assert got["crashed"]
    assert sorted(rid for rid, _ in got["rehomed"]) == sorted(got["crashed"])
    assert got["after"] == (0, "running", True)   # pools handed back
    assert set(got["done"]) >= set(got["crashed"])
    # recompute is bit-identical: same prompt, same seeded sampler
    assert got["outs"] == _reference(setup, PORT, specs)


def test_engine_crash_recovery_refuses_without_capacity(setup, tmp_path):
    def run(side):
        err = JManagerError if side == JAX else TManagerError
        fleet = _fleet(setup, side, tmp_path / side, num_engines=1)
        req = _req(side, 0, np.arange(5) % 100, 6)
        fleet.submit(req)
        fleet.step()
        before = list(req.out)
        with pytest.raises(err, match="no sibling") as e:
            fleet.recover_engine("serve0")
        return {"msg": str(e.value), "same": list(req.out) == before,
                "owns": fleet.tenants["serve0"].owns_request(req.rid)}

    got = _both(run)
    assert got["same"] and got["owns"]


# ===========================================================================
# control plane: in-flight load justifies a rebalance
# ===========================================================================
def test_rebalance_justified_by_inflight_only_load():
    def run(side):
        Stats, Snap, Action, Config, justify = (
            (JStats, JSnap, JAction, JConfig, jjustify) if side == JAX
            else (TStats, TSnap, TAction, TConfig, tjustify))
        hot = Stats(tid="a", index=0, status="running", load=6,
                    queue_depth=0, inflight=6)
        cold = Stats(tid="b", index=1, status="running", load=0)
        cfg = Config(rebalance_gap=4)
        ok = justify(Action("rebalance",
                            Snap(epoch=1, slo_max_load=6,
                                 engines=(hot, cold)),
                            victim="a", target="b"), cfg)
        idle_hot = dataclasses.replace(hot, queue_depth=0, inflight=0)
        bad = justify(Action("rebalance",
                             Snap(epoch=2, slo_max_load=6,
                                  engines=(idle_hot, cold)),
                             victim="a", target="b"), cfg)
        return ok, bad

    ok, bad = _both(run)
    assert ok is None and "nothing queued or in flight" in bad


# ===========================================================================
# sim plane: scenario op + I13
# ===========================================================================
def test_scenario_traffic_with_migrations_holds_invariants():
    for seed in (1, 3):
        kw = dict(seed=seed, num_ops=40, serve_rate=0.5, migrate_rate=0.25,
                  autoscale_rate=0.1)
        jr = jsim.ScenarioRunner(jsim.ScenarioConfig(**kw))
        want = jr.run()
        tr = tsim.ScenarioRunner(tsim.ScenarioConfig(**kw), device="cpu")
        got = tr.run()          # invariants (incl. I13) run per op
        assert any(r.op.kind == "migrate_request" for r in got.ops)
        assert got.fingerprint() == want.fingerprint()
        assert got.virtual_seconds == want.virtual_seconds
        migrated = {tid: (getattr(tn, "migrations_in", 0),
                          getattr(tn, "migrations_out", 0))
                    for tid, tn in tr.tenants.items()}
        assert migrated == {tid: (getattr(tn, "migrations_in", 0),
                                  getattr(tn, "migrations_out", 0))
                            for tid, tn in jr.tenants.items()}
        assert sum(i for i, _ in migrated.values()) > 0
        for tid, jt in jr.tenants.items():
            if hasattr(jt, "requests"):
                assert ([(r.rid, r.out, r.done)
                         for r in tr.tenants[tid].requests]
                        == [(r.rid, r.out, r.done) for r in jt.requests])


def _sim_mgr(side, workdir, tenants):
    Pool, Manager, Staging = ((JPool, JManager, JStaging) if side == JAX
                              else (TPool, TManager, TStaging))
    pool = Pool(devices=tuple(f"d{i}" for i in range(8)), max_vfs=4)
    mgr = Manager(pool, workdir=str(workdir),
                  staging=Staging(num_queues=2), scheduler="first_fit")
    mgr.init(len(tenants), tenants, devices_per_vf=2)
    return mgr


def test_i13_catches_request_live_on_two_engines(tmp_path):
    def run(side):
        sim = jsim if side == JAX else tsim
        kw = {} if side == JAX else {"device": "cpu"}
        sv0 = sim.SimServeTenant("sv0", seed=5, **kw)
        sv1 = sim.SimServeTenant("sv1", seed=6, **kw)
        mgr = _sim_mgr(side, tmp_path / side, [sv0, sv1])
        sv0.submit_burst(3)
        for _ in range(6):
            sv0.run_steps(1)
            if sv0.peek_migratable() is not None:
                break
        rid = sv0.peek_migratable()
        sim.check_invariants(mgr)                  # healthy before
        # corrupt: admit on the target WITHOUT releasing the source
        payload = sv0.extract_request()
        sv1.admit_migrated(payload, payload["state"])
        with pytest.raises(sim.InvariantViolation, match="I13") as e:
            sim.check_invariants(mgr)
        # roll the target admission back: healthy again
        sv1.abort_incoming(payload["rid"])
        sv0.abort_migration(payload["rid"])
        sim.check_invariants(mgr)
        return rid, str(e.value), sv1.migrations_in

    rid, msg, n_in = _both(run)
    assert rid is not None and n_in == 1


# ===========================================================================
# chunked prefill
# ===========================================================================
@pytest.mark.parametrize("plen,C", [(5, 8), (13, 4), (16, 8)])
def test_chunked_prefill_logits_match_jax(setup, plen, C, monkeypatch):
    """Every chunk's logits and the staging cache after it, within the
    fp32 tolerance, from a first chunk at offset 0 whose staging cache
    (C * next_pow2(ceil(plen / C)) rows) is longer than the chunk. No
    chunk reaches the flash_attention wrapper: each takes the plain
    attention over the whole staging cache, as JAX's traced offset."""
    (jrun, jp), (trun, tp) = setup[JAX], setup[PORT]
    jm, tm = jax_model(jrun), torch_model(trun)
    cap = C * (1 << max(0, (-(-plen // C) - 1).bit_length()))
    assert cap > C or plen <= C
    shape = dataclasses.replace(jrun.shape, seq_len=cap, global_batch=1)
    jcache = jm.init_cache(shape)
    tcache = tm.init_cache(dataclasses.replace(trun.shape, seq_len=cap,
                                               global_batch=1),
                           device="cpu")
    toks = np.random.default_rng(plen).integers(0, 500, plen)

    def no_kernel(*a, **k):
        raise AssertionError("a chunk reached the flash_attention wrapper")
    monkeypatch.setattr(kops, "flash_attention", no_kernel)
    for off in range(0, plen, C):
        chunk = np.zeros((C,), np.int32)
        real = min(C, plen - off)
        chunk[:real] = toks[off:off + real]
        jcache, jlog = jax.jit(jm.prefill_chunk)(
            jp, jcache, jnp.asarray(chunk)[None], jnp.int32(off))
        tcache, tlog = tm.prefill_chunk(tp, tcache,
                                        torch.tensor(chunk[None]),
                                        torch.tensor(off))
        np.testing.assert_allclose(tlog[0, :real].numpy(),
                                   np.asarray(jlog)[0, :real],
                                   atol=TOL32, rtol=TOL32)
        for blk in jcache:
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    tcache[blk][name][:, :, :off + real].numpy(),
                    np.asarray(jcache[blk][name])[:, :, :off + real],
                    atol=TOL32, rtol=TOL32)
    monkeypatch.undo()
    # the last real row equals the whole-prompt prefill's last logits
    _, whole = tm.prefill(tp, {"tokens": torch.tensor(toks[None])})
    np.testing.assert_allclose(tlog[0, (plen - 1) % C].numpy(),
                               whole[0].numpy(), atol=TOL32, rtol=TOL32)


def test_chunked_prefill_engine_matches_jax(setup):
    """An engine with prefill_chunk 4: one chunk per step, interleaved
    with the batch's decode; the same token streams as the JAX engine
    (long prompts chunked, a short one whole), and a suspend mid-job
    re-queues the job and replays it token-identically."""
    specs = [(i, (np.arange(n) * (i + 3) + 1) % 300, 5)
             for i, n in enumerate((13, 3, 9, 6))]

    def run(side):
        run_cfg, params = setup[side]
        kw = dict(slots=2, max_len=48, page_size=8, prefill_chunk=4)
        eng = (JEngine(run_cfg, params, paged=True, **kw) if side == JAX
               else TEngine(run_cfg, params, device="cpu", paged=True,
                            **kw))
        reqs = [_req(side, rid, p, n, **_sampling(rid))
                for rid, p, n in specs]
        for r in reqs:
            eng.submit(r)
        eng.step()
        jobs = sorted(eng._jobs)
        eng.abort_prefill_jobs()              # what a suspend does
        requeued = [r.rid for r in eng.queue]
        res = eng.run_until_idle()
        return {"jobs": jobs, "requeued": requeued,
                "drained": res.drained,
                "outs": {r.rid: list(r.out) for r in reqs}}

    got = _both(run)
    assert got["jobs"] == [0] and got["requeued"][0] == 0
    assert got["drained"]
    assert got["outs"] == _reference(setup, PORT, specs)


# ===========================================================================
# the hybrid twin: a request migrates with its recurrent slot state
# ===========================================================================
def test_hybrid_request_migrates_with_recurrent_state(hybrid, tmp_path):
    specs = [(0, (np.arange(16) * 7 + 2) % 300, 6),
             (1, (np.arange(9) * 5 + 1) % 300, 5)]

    def run(side):
        fleet = _fleet(hybrid, side, tmp_path / side)
        reqs = [_req(side, rid, p, n, **_sampling(rid))
                for rid, p, n in specs]
        for r in reqs:
            fleet.submit(r)
        for _ in range(2):
            fleet.step()
        src = fleet.tenants["serve0"].engine
        dst = fleet.tenants["serve1"].engine
        slot = next(s for s, r in enumerate(src.active)
                    if r is not None and r.rid == 0)
        before = {name: np.asarray(leaf[:, slot]).copy()
                  for name, leaf in _dense_state(src)}
        res = fleet.migrate_request("serve0", "serve1", 0)
        tslot = next(s for s, r in enumerate(dst.active)
                     if r is not None and r.rid == 0)
        moved = all(np.array_equal(np.asarray(leaf[:, tslot]), before[name])
                    for name, leaf in _dense_state(dst))
        fleet.drain()
        return {"blocks": res["blocks"], "moved": moved,
                "names": sorted(before),
                "outs": {r.rid: list(r.out) for r in reqs}}

    got = _both(run)
    assert got["moved"] and got["blocks"] >= 1
    assert any(n.endswith(("conv", "ssm")) for n in got["names"])
    assert got["outs"] == _reference(hybrid, PORT, specs)


def _dense_state(eng):
    """(block/name, leaf) of every per-slot recurrent-state leaf."""
    out = []
    for blk, node in eng._cache.items():
        for name, leaf in node.items():
            if name not in ("k", "v", "k_scale", "v_scale"):
                out.append((f"{blk}/{name}", leaf.cpu() if isinstance(
                    leaf, torch.Tensor) else leaf))
    return out


# ===========================================================================
# the int8 KV scale
# ===========================================================================
def test_kv_scale_matches_the_jax_engines_jitted_quantizer():
    """The JAX engine quantizes inside ``jit``, where ``max|x| / 127``
    becomes a multiply by float32(1/127): the port's scales equal that,
    bit for bit, and so does the dequant -> requant composition (which
    can move a scale by one ulp, in both packages alike)."""
    x = np.random.default_rng(0).standard_normal((4096, 8, 128), np.float32)
    qj, sj = jax.jit(jpaged.kv_quantize)(x)
    qt, st = tref.kv_quant_ref(torch.from_numpy(x))
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy().view(np.uint32),
                          np.asarray(sj).view(np.uint32))
    dj = jax.jit(jpaged.kv_dequantize)(qj, sj)
    dt = tref.kv_dequant_ref(qt, st)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    q2j, s2j = jax.jit(jpaged.kv_quantize)(dj)
    q2t, s2t = tref.kv_quant_ref(dt)
    assert np.array_equal(q2t.numpy(), np.asarray(q2j))
    assert np.array_equal(s2t.numpy().view(np.uint32),
                          np.asarray(s2j).view(np.uint32))
    # the reference's round trip is not the identity under jit
    assert (np.asarray(s2j) != np.asarray(sj)).sum() > 0


def test_int8_migration_target_pages_are_the_requantized_source(setup,
                                                                tmp_path):
    """int8 fleets: a migrated request's target pages and scales equal,
    bit for bit, the plain requantization of the source's dequantized
    pages (what the JAX engine's jitted admission computes); the token
    streams equal the JAX fleet's."""
    specs = [(0, (np.arange(11) * 5 + 2) % 100, 6),
             (1, (np.arange(7) * 3) % 100, 5)]

    def run(side):
        fleet = _fleet(setup, side, tmp_path / side, kv_dtype="int8")
        reqs = [_req(side, rid, p, n, **_sampling(rid))
                for rid, p, n in specs]
        for r in reqs:
            fleet.submit(r)
        for _ in range(2):
            fleet.step()
        src = fleet.tenants["serve0"].engine
        dst = fleet.tenants["serve1"].engine
        chain = src.alloc.pages_of(0)
        if side == PORT:
            pools = {(blk, n): (node[n][:, chain].clone(),
                                node[n + "_scale"][:, chain].clone())
                     for blk, node in src._cache.items()
                     for n in ("k", "v")}
        fleet.migrate_request("serve0", "serve1", 0)
        if side == PORT:
            tchain = dst.alloc.pages_of(0)
            for (blk, n), (q, s) in pools.items():
                want_q, want_s = tref.kv_quant_ref(tref.kv_dequant_ref(q, s))
                node = dst._cache[blk]
                assert torch.equal(node[n][:, tchain], want_q)
                assert torch.equal(node[n + "_scale"][:, tchain].view(
                    torch.int32), want_s.view(torch.int32))
        fleet.drain()
        return {r.rid: list(r.out) for r in reqs}

    _both(run)


# ===========================================================================
# the driver
# ===========================================================================
def _jax_benchmark(name):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / name
    spec = importlib.util.spec_from_file_location(f"jax_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_migration_driver_matches_the_jax_benchmark():
    """``python -m repro_torch.bench.migration --device cpu --smoke`` at a
    shorter trace: its rows' tick metrics, migration counters and gates
    equal the JAX benchmark's (they depend on arrivals and slots, not on
    the weights), and its gates pass."""
    from repro_torch.bench import migration as tmig
    kw = dict(ticks=24, max_new=6, slots=4, slo_max_load=8)
    want = _jax_benchmark("migration.py").bench(**kw)
    run = torch_run_config(ARCH, "decode_32k", smoke=True)
    params = torch_model(run).init(seed=0, device="cpu")
    got = tmig.bench(run, params, torch.device("cpu"), log=lambda s: None,
                     **kw)
    drop = ("wall_s", "device", "model")
    assert ([{k: v for k, v in r.items() if k not in drop} for r in got]
            == [{k: v for k, v in r.items() if k not in drop}
                for r in want])
    assert got[-1]["all_gates"] and got[-1]["migrations_completed"] >= 1
