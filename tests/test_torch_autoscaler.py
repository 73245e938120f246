"""The port's elastic SLO control plane against the JAX package's, on the
CPU (mirrors ``tests/test_autoscaler.py`` case for case).

Policy-loop cases feed the same synthetic telemetry to both packages'
``Autoscaler`` and require the same actions (kind, victim, target,
width, reason) and the same ``justify_action`` verdicts. Fleet cases run
both packages' ``ServeFleet`` (the same params from the JAX init, fp32
compute, the same numpy requests) through scale-out, scale-in and
rebalance and require equal token streams, journals and pool tables. Sim
cases run both packages' ``ScenarioRunner`` with the autoscale op on and
require equal fingerprints and autoscaler histories, with I11 checked
after every autoscale op.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.core.autoscaler as jas
import repro.core.fault as jfault
import repro.sim as jsim
import repro.sim.harness as jharness
import repro_torch.core.autoscaler as tas
import repro_torch.core.fault as tfault
import repro_torch.sim as tsim
import repro_torch.sim.harness as tharness
from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.core import ManagerError as JManagerError
from repro.models.model import build_model as jax_model
from repro.serve import Request as JRequest
from repro.serve import ServeFleet as JFleet
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.core.errors import ManagerError as TManagerError
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.fleet import ServeFleet as TFleet

JAX, PORT = "jax", "port"
AS = {JAX: jas, PORT: tas}
SIM = {JAX: jsim, PORT: tsim}


@pytest.fixture(scope="module")
def setup():
    jrun = jax_run_config("qwen3-0.6b", "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"))
    trun = torch_run_config("qwen3-0.6b", "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"))
    jp = jax_model(jrun).init(jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return {JAX: (jrun, jp), PORT: (trun, tp)}


def snap(side, loads, *, epoch=0, slo=8, free_vfs=1, grow=0, queued=None,
         jobs=None, widths=None, wmax=None, bubbles=None):
    """Synthetic telemetry: engine i running at loads[i]; widths/wmax/
    bubbles optionally give each engine a pipeline-gang shape."""
    m = AS[side]
    queued = queued if queued is not None else loads
    jobs = jobs or [0] * len(loads)
    widths = widths or [1] * len(loads)
    wmax = wmax or widths
    bubbles = bubbles or [0.0] * len(loads)
    return m.TelemetrySnapshot(
        epoch=epoch, slo_max_load=slo,
        engines=tuple(
            m.EngineStats(tid=f"e{i}", index=i, status="running",
                          load=loads[i], queue_depth=queued[i],
                          prefill_jobs=jobs[i], stage_width=widths[i],
                          stage_width_max=wmax[i], bubble_frac=bubbles[i])
            for i in range(len(loads))),
        free_vfs=free_vfs, grow_budget=grow)


def _act(a):
    return None if a is None else (a.kind, a.victim, a.target, a.width,
                                   a.reason)


def _observe(side, cfg_kw, feeds):
    """Feed ``feeds`` (snap kwargs, one per epoch) to a fresh autoscaler;
    returns each epoch's action and the justification of each action."""
    m = AS[side]
    cfg = m.AutoscaleConfig(**cfg_kw)
    a = m.Autoscaler(cfg)
    out = []
    for loads, kw in feeds:
        act = a.observe(snap(side, loads, **kw))
        out.append((_act(act),
                    None if act is None else m.justify_action(act, cfg)))
    return out


def _both_observe(cfg_kw, feeds):
    want = _observe(JAX, cfg_kw, feeds)
    got = _observe(PORT, cfg_kw, feeds)
    assert got == want
    return got


def test_module_surface_matches_jax():
    for name in ("EngineStats", "TelemetrySnapshot", "AutoscaleAction",
                 "AutoscaleConfig"):
        assert ([(f.name, f.default) for f in
                 dataclasses.fields(getattr(tas, name))]
                == [(f.name, f.default) for f in
                    dataclasses.fields(getattr(jas, name))])
    assert tas.ACTION_KINDS == jas.ACTION_KINDS


# ===========================================================================
# policy loop
# ===========================================================================
def test_scale_out_needs_hot_engine_and_capacity():
    got = _both_observe(dict(hysteresis=1, cooldown=0),
                        [([2], {}), ([8], {})])
    assert got[0][0] is None                       # below threshold
    assert got[1][0][0] == "scale_out" and got[1][1] is None
    # no capacity -> no action even when hot
    got = _both_observe(dict(hysteresis=1, cooldown=0),
                        [([8], dict(free_vfs=0, grow=0))])
    assert got[0][0] is None


def test_hysteresis_requires_sustained_condition():
    got = _both_observe(dict(hysteresis=3, cooldown=0),
                        [([8], {}), ([8], {}), ([0], {}), ([8], {}),
                         ([8], {}), ([8], {})])
    assert [a is None for a, _ in got] == [True] * 5 + [False]
    assert got[-1][0][0] == "scale_out"


def test_cooldown_suppresses_flapping_on_oscillating_load():
    """Load oscillating hot/idle every epoch produces at most one action
    per (1 + cooldown) epochs; steady balanced load produces none."""
    cfg = dict(hysteresis=1, cooldown=4, min_engines=1)
    got = _both_observe(cfg, [([9 if e % 2 == 0 else 0, 1],
                               dict(epoch=e)) for e in range(32)])
    epochs = [e for e, (a, _) in enumerate(got) if a is not None]
    assert len(epochs) <= 32 // 5 + 1
    assert all(b - a > 4 for a, b in zip(epochs, epochs[1:]))
    got = _both_observe(cfg, [([3, 3], dict(epoch=i)) for i in range(10)])
    assert all(a is None for a, _ in got)


def test_scale_in_only_when_idle_and_above_floor():
    got = _both_observe(dict(hysteresis=2, cooldown=0, min_engines=1),
                        [([0, 0], {}), ([0, 0], {})])
    assert got[0][0] is None
    assert got[1][0][:2] == ("scale_in", "e1") and got[1][1] is None
    got = _both_observe(dict(hysteresis=1, cooldown=0, min_engines=1),
                        [([0], {}), ([0], {})])
    assert all(a is None for a, _ in got)          # at the floor: never


def test_rebalance_preferred_over_scale_out_when_cold_engine_exists():
    got = _both_observe(dict(hysteresis=1, cooldown=0, rebalance_gap=4),
                        [([9, 0], {})])
    (kind, victim, target, _, _), why = got[0]
    assert (kind, victim, target, why) == ("rebalance", "e0", "e1", None)


def _forged(side, bogus):
    """justify_action and check_autoscale (I11) on forged actions."""
    m, sim = AS[side], SIM[side]
    cfg = m.AutoscaleConfig()
    out = []
    for kind, loads, kw, act_kw in bogus:
        act = m.AutoscaleAction(kind, snap(side, loads, **kw), **act_kw)
        err = m.justify_action(act, cfg)
        with pytest.raises(sim.InvariantViolation, match="I11") as e:
            sim.check_autoscale(act, cfg)
        out.append((err, str(e.value)))
    return out


def test_justification_catches_unjustified_actions():
    """I11 has teeth: actions forged against a snapshot that does not
    support them are named violations, with the JAX package's text."""
    bogus = [("scale_out", [0, 0], {}, {}),
             ("scale_in", [5, 5], {}, {"victim": "e1"}),
             ("rebalance", [3, 2], {}, {"victim": "e0", "target": "e1"}),
             ("warp", [0, 0], {}, {})]
    got = _forged(PORT, bogus)
    assert got == _forged(JAX, bogus)
    for (err, _), needle in zip(got, ("no engine at load", "busy engine",
                                      "without imbalance",
                                      "unknown action")):
        assert needle in err


# ===========================================================================
# the width dimension: pure policy over a snapshot
# ===========================================================================
def test_grow_reshape_only_when_engines_maxed():
    gang = dict(widths=[2], wmax=[4], free_vfs=1)
    got = _both_observe(dict(hysteresis=1, cooldown=0, max_engines=1),
                        [([9], gang)])
    assert got[0][0][:4] == ("reshape", "e0", None, 3) and got[0][1] is None
    got = _both_observe(dict(hysteresis=1, cooldown=0, max_engines=4),
                        [([9], gang)])
    assert got[0][0][0] == "scale_out"             # engine headroom wins
    for kw in (dict(gang, free_vfs=0), dict(widths=[4], wmax=[4],
                                            free_vfs=1)):
        got = _both_observe(dict(hysteresis=1, cooldown=0, max_engines=1),
                            [([9], kw)])
        assert got[0][0] is None


def test_shrink_reshape_on_measured_bubble():
    cfg = dict(hysteresis=1, cooldown=0, min_engines=1)
    got = _both_observe(cfg, [([2, 3], dict(widths=[3, 1], wmax=[4, 1],
                                            bubbles=[0.7, 0.0]))])
    assert got[0][0][:4] == ("reshape", "e0", None, 2) and got[0][1] is None
    got = _both_observe(cfg, [([2, 3], dict(widths=[3, 1], wmax=[4, 1],
                                            bubbles=[0.2, 0.0]))])
    assert got[0][0] is None


def test_justification_catches_unjustified_reshapes():
    bogus = [("reshape", [9], {}, {"victim": "e9", "width": 2}),
             ("reshape", [9], dict(widths=[2], wmax=[4]),
              {"victim": "e0", "width": 2}),
             ("reshape", [9], dict(widths=[2], wmax=[2]),
              {"victim": "e0", "width": 3}),
             ("reshape", [1], dict(widths=[2], wmax=[4]),
              {"victim": "e0", "width": 3}),
             ("reshape", [9], dict(widths=[2], wmax=[4], free_vfs=0),
              {"victim": "e0", "width": 3}),
             ("reshape", [5], dict(widths=[2], wmax=[4], bubbles=[0.1]),
              {"victim": "e0", "width": 1})]
    got = _forged(PORT, bogus)
    assert got == _forged(JAX, bogus)
    for (err, _), needle in zip(got, ("not running", "to width 2 from 2",
                                      "template ceiling", "hot threshold",
                                      "free VF", "busy")):
        assert needle in err


# ===========================================================================
# real fleet: scale-out / scale-in / rebalance through the manager
# ===========================================================================
def _fleet(setup, side, tmp_path, **kw):
    run, params = setup[side]
    workdir = str(tmp_path / side)
    if side == JAX:
        return JFleet(run, params, workdir=workdir, **kw)
    return TFleet(run, params, device="cpu", workdir=workdir, **kw)


def _req(side, rid, prompt, new):
    cls = JRequest if side == JAX else TRequest
    return cls(rid=rid, prompt=prompt, max_new_tokens=new)


def _journal(fleet):
    return [(e["op"], e["tenant"], e["vf_id"], e["status"])
            for e in fleet.mgr.journal.entries()]


def _vf_table(fleet):
    return [(vf.vf_id, vf.state.value, vf.owner,
             tuple(str(d) for d in vf.devices))
            for vf in fleet.pool.vfs.values()]


def _both(fn, *args):
    want, got = fn(JAX, *args), fn(PORT, *args)
    assert got == want
    return got


def test_fleet_vf_cap_follows_device_budget_and_scales_out(setup, tmp_path):
    """The VF cap is the device budget, and scale-out past the initial
    fleet size (the grow path: a full reconf cycle carves one more VF)
    serves traffic on the new engine."""
    def run(side):
        fleet = _fleet(setup, side, tmp_path, num_engines=1, num_devices=4,
                       slots=2, max_len=48)
        cap = fleet.pool.max_vfs
        tid = fleet.scale_out()
        reqs = [_req(side, i, np.arange(4) % 50, 2) for i in range(4)]
        placed = [fleet.submit(r) for r in reqs]
        res = fleet.drain()
        return {"cap": cap, "tid": tid, "placed": placed,
                "running": sum(tn.status == "running"
                               for tn in fleet.tenants.values()),
                "drained": res.drained,
                "outs": [(r.out, r.done, r.error) for r in reqs],
                "journal": _journal(fleet), "vfs": _vf_table(fleet),
                "pending": fleet.mgr.query()["journal_pending"]}

    got = _both(run)
    assert got["cap"] == 4 and got["tid"] == "serve1"
    assert got["running"] == 2 and len(got["vfs"]) == 2
    assert set(got["placed"]) == {"serve0", "serve1"}
    assert got["drained"] and got["pending"] == 0
    assert all(done and err is None for _, done, err in got["outs"])


def test_fleet_precarved_vfs_make_scale_out_pause_free(setup, tmp_path):
    def run(side):
        fleet = _fleet(setup, side, tmp_path, num_engines=1, num_devices=4,
                       slots=2, max_len=48, num_vfs=2)
        nvf = len(fleet.pool.vfs)
        fleet.scale_out()
        return nvf, [e["op"] for e in fleet.mgr.journal.entries()]

    nvf, ops = _both(run)
    assert nvf == 2 and ops.count("attach") == 2 and "pause" not in ops


def test_fleet_scale_in_refuses_inflight_prefill_then_parks(setup,
                                                            tmp_path):
    """Scale-in refuses while the victim holds an in-flight chunked
    prefill (it has no sibling to drain to), and parks it once drained:
    state on disk, its VF detached with its devices."""
    def run(side):
        err = JManagerError if side == JAX else TManagerError
        fleet = _fleet(setup, side, tmp_path, num_engines=1, num_devices=2,
                       slots=2, max_len=48, prefill_chunk=3)
        eng = fleet.tenants["serve0"].engine
        req = _req(side, 0, (np.arange(8) * 5) % 100, 2)
        fleet.submit(req)
        fleet.step()
        jobs = sorted(eng._jobs)
        with pytest.raises(err, match="busy") as e:
            fleet.scale_in("serve0")
        status = fleet.tenants["serve0"].status
        res = fleet.drain()
        fleet.scale_in("serve0")
        vf = next(iter(fleet.pool.vfs.values()))
        return {"jobs": jobs, "msg": str(e.value), "status": status,
                "drained": res.drained, "out": list(req.out),
                "after": fleet.tenants["serve0"].status,
                "vf": (vf.owner, len(vf.devices)),
                "journal": _journal(fleet)}

    got = _both(run)
    assert got["jobs"] == [0] and got["status"] == "running"
    assert got["drained"] and got["after"] == "detached"
    assert got["vf"][0] is None and got["vf"][1] > 0   # devices reusable


def test_fleet_rebalance_moves_queue_and_keeps_tokens(setup, tmp_path):
    """Rebalance steals queued requests hot -> cold and migrates the hot
    victim; outputs equal an undisturbed run and the JAX fleet's."""
    def serve(side, rebalance):
        fleet = _fleet(setup, side, tmp_path / str(rebalance),
                       num_engines=2, num_devices=4, slots=1, max_len=48)
        reqs = [_req(side, i, (np.arange(4) * (i + 2)) % 100, 3)
                for i in range(5)]
        for r in reqs:
            fleet.tenants["serve0"].engine.submit(r)
        fleet.step()
        moved = queued = None
        if rebalance:
            moved = fleet.rebalance("serve0", "serve1")
            queued = len(fleet.tenants["serve1"].engine.queue)
        res = fleet.drain()
        assert res.drained and all(r.done and not r.error for r in reqs)
        return {"moved": moved, "queued": queued,
                "outs": [r.out for r in reqs], "journal": _journal(fleet),
                "pending": fleet.mgr.query()["journal_pending"]}

    plain = _both(serve, False)
    moved = _both(serve, True)
    assert moved["moved"] >= 1 and moved["queued"] >= 1
    assert moved["pending"] == 0 and moved["outs"] == plain["outs"]


# ===========================================================================
# sim: the autoscale op + I11 after every action
# ===========================================================================
def test_generator_autoscale_rate_zero_is_byte_identical():
    base = tsim.ScenarioConfig(seed=7, serve_rate=0.35, num_ops=30)
    with_field = tsim.ScenarioConfig(seed=7, serve_rate=0.35, num_ops=30,
                                     autoscale_rate=0.0)
    assert tsim.generate_scenario(base) == \
        tsim.generate_scenario(with_field)
    assert ([dataclasses.astuple(o) for o in tsim.generate_scenario(base)]
            == [dataclasses.astuple(o) for o in jsim.generate_scenario(
                jsim.ScenarioConfig(seed=7, serve_rate=0.35, num_ops=30))])


@pytest.mark.parametrize("arrival", ["ramp", "spike", "diurnal"])
def test_sim_autoscale_scenarios_hold_invariants(arrival):
    """Randomized serve + autoscale histories: replay-stable, equal to the
    JAX runner's (fingerprint, virtual time, autoscaler history), with
    I1-I11 checked after every op."""
    took = []
    for seed in (1, 2, 4, 7):
        kw = dict(seed=seed, serve_rate=0.45, autoscale_rate=0.3,
                  num_ops=40, arrival=arrival)
        jr = jsim.ScenarioRunner(jsim.ScenarioConfig(**kw))
        want = jr.run()
        tr = tsim.ScenarioRunner(tsim.ScenarioConfig(**kw), device="cpu")
        got = tr.run()
        assert got.fingerprint() == want.fingerprint()
        assert got.fingerprint() == tsim.ScenarioRunner(
            tsim.ScenarioConfig(**kw), device="cpu").run().fingerprint()
        assert got.virtual_seconds == want.virtual_seconds
        assert ([_act(a) for a in tr.autoscaler.history]
                == [_act(a) for a in jr.autoscaler.history])
        took.extend(a.kind for a in tr.autoscaler.history)
    assert "scale_out" in took       # the plane actually acts


def test_sim_i11_catches_seeded_unjustified_action(monkeypatch):
    """A planner that scales out on a COLD snapshot is caught by I11
    inside the harness, tagged with the reproducing seed/op#, in both
    packages alike."""
    def bad_observe(m):
        def observe(self, s):
            return m.AutoscaleAction("scale_out", s, reason="seeded bug")
        return observe
    kw = dict(seed=1, serve_rate=0.45, autoscale_rate=0.3, num_ops=40)
    msgs = []
    for side, runner in ((JAX, lambda: jsim.ScenarioRunner(
            jsim.ScenarioConfig(**kw))), (PORT, lambda: tsim.ScenarioRunner(
            tsim.ScenarioConfig(**kw), device="cpu"))):
        monkeypatch.setattr(AS[side].Autoscaler, "observe",
                            bad_observe(AS[side]))
        with pytest.raises(SIM[side].InvariantViolation, match="I11") as e:
            runner().run()
        msgs.append(str(e.value).split(":")[0])
    assert msgs[0] == msgs[1] and "seed=1" in msgs[1]


def _crash_mid_scale_out(side, workdir):
    sim, fault = (jsim, jfault) if side == JAX else (tsim, tfault)
    harness = jharness if side == JAX else tharness
    kw = dict(seed=2, serve_rate=0.45, autoscale_rate=0.3, num_ops=40,
              arrival="ramp")
    cfg = sim.ScenarioConfig(**kw)
    r = (sim.ScenarioRunner(cfg, workdir=str(workdir)) if side == JAX else
         sim.ScenarioRunner(cfg, workdir=str(workdir), device="cpu"))
    r._wd = str(workdir)                # _apply is driven without run()
    crashed_at = None
    try:
        for i, op in enumerate(sim.generate_scenario(cfg)):
            if op.kind == "autoscale":
                fault.crash_plane.arm("mid_record_write")
                try:
                    r._apply(op)
                except fault.InjectedCrash:
                    crashed_at = i
                    break
                finally:
                    fault.crash_plane.disarm()
            else:
                try:
                    r._apply(op)
                except harness.REJECTIONS:
                    pass               # chaos ops are meant to be rejected
    finally:
        fault.crash_plane.disarm()
    assert crashed_at is not None, "no scale_out materialized"
    r.mgr = sim.recover_manager(r.mgr, r.tenants, policy=cfg.policy,
                                workdir=str(workdir), num_queues=2)
    sim.check_invariants(r.mgr)
    return (crashed_at, r.mgr.query()["journal_pending"],
            sorted((tid, tn.status) for tid, tn in r.tenants.items()),
            [(e["op"], e["tenant"], e["status"],
              e["details"].get("recovered"))
             for e in r.mgr.journal.entries()])


def test_sim_crash_mid_scale_out_recovers_consistent(tmp_path):
    """A crash point fired mid-scale-out (inside the journaled attach the
    autoscaler's action executes through): recovery leaves an I8-clean
    journal and pool, idempotently (I9 inside recover_manager), and the
    recovered state equals the JAX package's."""
    got = _crash_mid_scale_out(PORT, tmp_path / "port")
    assert got == _crash_mid_scale_out(JAX, tmp_path / "jax")
    assert got[1] == 0


def test_elastic_sweep_driver_matches_the_jax_benchmark():
    """``python -m repro_torch.bench.elastic_sweep --device cpu --smoke``
    at a shorter trace: every row's tick metrics, rejections and actions
    and the summary's gates equal the JAX benchmark's (the plan reads
    loads only, which the weights do not move)."""
    import importlib.util
    import pathlib
    from repro_torch.bench import elastic_sweep as tel
    from repro_torch.models.model import build_model as torch_model
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "elastic_sweep.py")
    spec = importlib.util.spec_from_file_location("jax_elastic", path)
    jel = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jel)
    kw = dict(ticks=30, peak=3, max_new=6, slots=4, slo_max_load=8)
    want = jel.bench(**kw)
    run = torch_run_config("qwen3-0.6b", "decode_32k", smoke=True)
    params = torch_model(run).init(seed=0, device="cpu")
    got = tel.bench(run, params, "cpu", log=lambda s: None, **kw)
    drop = ("wall_s", "device", "model", "ttft_p95_ms", "itl_p95_ms")

    def strip(rows):
        return [{k: ([dict(a, reason=None) for a in v]
                     if k == "actions" else v)
                 for k, v in r.items() if k not in drop} for r in rows]
    assert strip(got) == strip(want)
    assert got[-1]["elastic_beats_static_spike_ramp"]
