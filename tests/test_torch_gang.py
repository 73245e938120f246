"""The port's gang ops — ``Scheduler.admit_gang``/``select_gang``,
``SVFFManager.attach_group``/``detach_group``/``reshape`` with their
recovery, the fleet's pipeline gangs (``ServeFleet(stages=...)``,
``reshape_engine``, ``handle_vf_loss``, stage telemetry, the gang-aware
scale-out budget) and the sim plane's gang lead — against the JAX
package's, on the CPU.

Both packages run the same operations on the same inputs; the journal's
entries (op, tenant, VF, status, details), the pool's VF table, the
tenants' statuses and widths, and the token streams must be equal. The
fleets compute in fp32 (params from the JAX init, converted), where
sampled streams agree between the frameworks; every gang stream also
equals an undisturbed single-stage fleet's.
"""
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest

import repro.core.fault as jfault
import repro.sim as jsim
import repro_torch.core.fault as tfault
import repro_torch.sim as tsim
from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.core import GangPlacementError as JGangError
from repro.core import ManagerError as JManagerError
from repro.core.manager import SVFFManager as JManager
from repro.core.pool import DevicePool as JPool
from repro.core.staging import StagingEngine as JStaging
from repro.models.model import build_model as jax_model
from repro.serve.engine import Request as JRequest
from repro.serve.fleet import ServeFleet as JFleet
from repro.sim.tenant import SimPipelineTenant as JLead
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.core import GangPlacementError, ManagerError
from repro_torch.core import DevicePool, SVFFManager, StagingEngine
from repro_torch.core.scheduler import (PlacementRequest,
                                        make_scheduler)
from repro_torch.serve.engine import Request
from repro_torch.serve.fleet import ServeFleet
from repro_torch.tree import tree_leaves

POLICIES = ("first_fit", "best_fit", "fair_share")
JAX = dict(sim=jsim, Pool=JPool, Manager=JManager, Staging=JStaging,
           fault=jfault, GangError=JGangError, ManagerError=JManagerError,
           Lead=JLead, kw={})
PORT = dict(sim=tsim, Pool=DevicePool, Manager=SVFFManager,
            Staging=StagingEngine, fault=tfault,
            GangError=GangPlacementError, ManagerError=ManagerError,
            Lead=tsim.SimPipelineTenant, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def disarmed():
    yield
    jfault.crash_plane.disarm()
    tfault.crash_plane.disarm()


def _journal(mgr):
    return [(e["op"], e["tenant"], e["vf_id"], e["status"],
             {k: v for k, v in e["details"].items() if k != "ts"})
            for e in mgr.journal.entries()]


def _vf_table(pool):
    return [(vf.vf_id, vf.state.value, vf.owner,
             tuple(str(d) for d in vf.devices))
            for vf in pool.vfs.values()]


def _gang_state(lead):
    return (lead.status, lead.stage_width,
            [(s.tid, s.status, s.vf_id) for s in lead.gang_shells])


def _manager(side, wd, devices=8, max_vfs=4, policy="first_fit"):
    pool = side["Pool"](devices=tuple(f"d{i}" for i in range(devices)),
                        max_vfs=max_vfs)
    return pool, side["Manager"](pool, workdir=str(wd),
                                 staging=side["Staging"](num_queues=2),
                                 scheduler=policy)


# ===========================================================================
# scheduler and manager
# ===========================================================================
def _admission(side, wd):
    sim = side["sim"]
    pool, mgr = _manager(side, wd, devices=4, max_vfs=2)
    vm0 = sim.SimTenant("vm0", seed=1, **side["kw"])
    mgr.init(2, [vm0])                    # 1 free VF, the gang needs 2
    lead = side["Lead"]("pg0", seed=2, width=2, max_width=2,
                        **side["kw"])
    with pytest.raises(side["GangError"]):
        mgr.attach_group(lead)
    obs = [_gang_state(lead), _vf_table(pool), _journal(mgr)]
    assert lead.status == "created"
    assert all(vf.owner in (None, "vm0") for vf in pool.vfs.values())
    assert not [e for e in mgr.journal.entries()
                if e["status"] == "pending"]
    sim.check_invariants(mgr)
    mgr.detach(vm0)                       # room appears: attach succeeds
    mgr.attach_group(lead)
    sim.check_invariants(mgr)
    obs += [_gang_state(lead), _vf_table(pool), _journal(mgr)]
    return obs


def test_gang_admission_error_is_atomic(tmp_path):
    """A gang that cannot be placed whole is refused typed and side-effect
    free (no member bound, no VF claimed, no pending entry), then the same
    gang attaches once room exists — as in the JAX package."""
    got = _admission(PORT, tmp_path / "t")
    assert got == _admission(JAX, tmp_path / "j")
    assert got[3][0] == "running" and got[3][2][0][1] == "running"


@pytest.mark.parametrize("policy", POLICIES)
def test_select_gang_matches_jax(policy, tmp_path):
    """``select_gang`` picks the JAX scheduler's K distinct VFs, in request
    order, on a pool of mixed VF sizes; a gang wider than the free VFs is
    refused by both."""
    from repro.core.scheduler import PlacementRequest as JRequestP
    from repro.core.scheduler import make_scheduler as jmake
    picks = []
    for side, Req, make in ((PORT, PlacementRequest, make_scheduler),
                            (JAX, JRequestP, jmake)):
        pool = side["Pool"](devices=tuple(f"d{i}" for i in range(12)),
                            max_vfs=6)
        pool.set_num_vfs(5, 2)
        sched = make(policy)
        reqs = [Req(tenant_id=f"g{i}", min_devices=1 + i % 2)
                for i in range(3)]
        picks.append([vf.vf_id for vf in sched.select_gang(pool, {},
                                                           reqs)])
        with pytest.raises(side["GangError"]):
            sched.select_gang(pool, {}, [Req(tenant_id=f"h{i}")
                                         for i in range(6)])
        with pytest.raises(side["GangError"]):
            sched.admit_gang(pool, {}, [])
    assert picks[0] == picks[1] and len(set(picks[0])) == 3


def _gang_ops(side, wd):
    """attach_group, a grow and a shrink reshape (the VF-loss form with
    ``drop``), refusals, detach_group and a re-attach, on a pool with a
    bystander; the observations after each op."""
    sim = side["sim"]
    pool, mgr = _manager(side, wd)
    vm0 = sim.SimTenant("vm0", seed=1, **side["kw"])
    mgr.init(num_vfs=4, tenants=[vm0], devices_per_vf=2)
    lead = side["Lead"]("pg0", seed=3, width=2, max_width=3,
                        **side["kw"])
    obs = []

    def note(res=None):
        sim.check_invariants(mgr)
        obs.append((_gang_state(lead), _vf_table(pool), _journal(mgr),
                    None if res is None else
                    {k: v for k, v in res.items() if k != "reshape_s"}))

    mgr.attach_group(lead)
    lead.submit_burst(3)
    lead.run_steps(2)
    note()
    note(mgr.reshape(lead, 3))
    lead.run_steps(2)
    for call in (lambda: mgr.reshape(lead, 3),         # already there
                 lambda: mgr.reshape(lead, 4),         # no template
                 lambda: mgr.reshape(lead, 2, drop="vm0"),
                 lambda: mgr.attach_group(vm0)):       # not a gang lead
        with pytest.raises(side["ManagerError"]):
            call()
    note(mgr.reshape(lead, 2, drop="pg0.s1"))
    mgr.detach_group(lead)
    note()
    mgr.attach_group(lead)
    for _ in range(12):
        lead.run_steps(1)
    note()
    obs.append([(r.rid, r.out, r.done) for r in lead.requests])
    return obs


def test_gang_ops_match_jax(tmp_path):
    """Clean runs of every gang op: the same journal entries, VF table,
    member statuses and widths as JAX's, I1-I14 after each op."""
    got = _gang_ops(PORT, tmp_path / "t")
    assert got == _gang_ops(JAX, tmp_path / "j")
    assert [o[0][1] for o in got[:-1]] == [2, 3, 2, 2, 2]
    assert got[4][0][0] == "running"
    assert all(done for _, _, done in got[-1])


def _crash(side, wd, point):
    """Arm ``point``, run its gang op, crash, recover: the recovered
    journal (with each entry's resolution), VF table and gang."""
    sim = side["sim"]
    pool, mgr = _manager(side, wd)
    vm0 = sim.SimTenant("vm0", seed=1, **side["kw"])
    lead = side["Lead"]("pg0", seed=4, width=2, max_width=3,
                        **side["kw"])
    tenants = {"vm0": vm0, "pg0": lead,
               **{s.tid: s for s in lead.gang_shells}}
    mgr.init(num_vfs=4, tenants=[vm0], devices_per_vf=2)
    if point.startswith("reshape"):
        mgr.attach_group(lead)
        lead.submit_burst(2)
        lead.run_steps(2)
    side["fault"].crash_plane.arm(point)
    with pytest.raises(side["fault"].InjectedCrash):
        if point.startswith("reshape"):
            mgr.reshape(lead, 3)
        else:
            mgr.attach_group(lead)
    side["fault"].crash_plane.disarm()
    mgr = sim.recover_manager(mgr, tenants, policy="first_fit",
                              workdir=str(wd))
    sim.check_invariants(mgr)
    return (_gang_state(lead), _vf_table(mgr.pool),
            [(e["op"], e["tenant"], e["status"],
              e["details"].get("recovered")) for e in mgr.journal.entries()])


@pytest.mark.parametrize("point", ["gang_mid_member", "gang_before_commit",
                                   "reshape_mid_members",
                                   "reshape_before_commit"])
def test_gang_crash_windows_recover(point, tmp_path):
    """A crash mid-gang-attach rolls the whole gang back, before the
    commit rolls it forward; a crashed reshape lands on exactly the old or
    the new width (I14) — the JAX package's journal resolutions, VF table
    and gang, and the cataloged outcome."""
    got = _crash(PORT, tmp_path / "t", point)
    assert got == _crash(JAX, tmp_path / "j", point)
    want_width = {"gang_mid_member": 2, "gang_before_commit": 2,
                  "reshape_mid_members": 2, "reshape_before_commit": 3}
    status, width, shells = got[0]
    assert width == want_width[point]
    live = sum(1 for _, s, _ in shells if s == "running")
    assert live == (0 if point == "gang_mid_member" else width - 1)
    assert status == ("detached" if point == "gang_mid_member"
                      else "running")


# ===========================================================================
# the fleet's gangs (fp32 compute, params from the JAX init)
# ===========================================================================
_SETUPS = {}


def _setup(arch, layers=None):
    if (arch, layers) not in _SETUPS:
        jrun = jax_run_config(arch, "decode_32k", smoke=True,
                              precision=JPrecision(compute="float32"))
        trun = torch_run_config(arch, "decode_32k", smoke=True,
                                precision=TPrecision(compute="float32"))
        if layers:
            jrun = dataclasses.replace(jrun, model=dataclasses.replace(
                jrun.model, num_layers=layers))
            trun = trun.replace(model=dataclasses.replace(
                trun.model, num_layers=layers))
        jrun = dataclasses.replace(jrun, sharding=dataclasses.replace(
            jrun.sharding, scan_layers=False))
        jp = jax_model(jrun).init(jax.random.key(0))
        tp = interop.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _SETUPS[(arch, layers)] = (jrun, jp, trun, tp)
    return _SETUPS[(arch, layers)]


def _fleet(is_jax, setup, wd, **kw):
    jrun, jp, trun, tp = setup
    kw = dict(dict(num_engines=1, num_devices=4, stages=2, slots=2,
                   max_len=48, workdir=str(wd)), **kw)
    if is_jax:
        return JFleet(jrun, jp, **kw)
    return ServeFleet(trun, tp, device="cpu", **kw)


def _reqs(cls, n=3, new=6):
    prompts = [np.arange(4) % 97, (np.arange(7) * 3) % 97,
               (np.arange(5) * 5 + 2) % 97, (np.arange(6) * 7 + 1) % 97]
    return [cls(rid=i, prompt=np.asarray(prompts[i % 4], np.int32),
                max_new_tokens=new, temperature=0.8 if i % 2 else 0.0,
                top_k=16 if i % 4 == 1 else 0, seed=7 + i)
            for i in range(n)]


def _vf_loss(is_jax, setup, wd):
    fleet = _fleet(is_jax, setup, wd)
    tn = fleet.tenants["serve0"]
    assert tn.stage_width == 2
    reqs = _reqs(JRequest if is_jax else Request)
    for r in reqs:
        fleet.submit(r)
    for _ in range(3):
        fleet.step()
    snap = fleet.telemetry_snapshot()
    e = next(s for s in snap.engines if s.tid == "serve0")
    assert e.stage_width == 2 and e.stage_width_max == 2
    assert len(e.stage_loads) == 2 and 0.0 <= e.bubble_frac <= 1.0
    desc = fleet.telemetry.describe()["serve0"]
    assert len(desc["stage_loads"]) == 2
    shell = tn.gang_shells[0]
    assert shell.status == "running"
    info = fleet.handle_vf_loss("serve0", shell.vf_id)
    with pytest.raises((JManagerError, ManagerError)):
        fleet.handle_vf_loss("serve0", "vf9")
    with pytest.raises((JManagerError, ManagerError)):
        fleet.reshape_engine("serve0", 3)
    assert fleet.drain().drained
    assert not [ent for ent in fleet.mgr.journal.entries()
                if ent["status"] == "pending"]
    return ([list(r.out) for r in reqs],
            {k: v for k, v in info.items() if k != "reshape_s"},
            _gang_state(tn), _vf_table(fleet.pool), _journal(fleet.mgr),
            fleet.query()["engines"]["serve0.s1"]
            if "serve0.s1" in fleet.query()["engines"] else None)


def test_fleet_vf_loss_fallback_and_stage_telemetry(tmp_path):
    """A shell VF dies mid-serving: the fleet sheds that stage (journaled
    reshape K=2 -> 1), and every stream equals the JAX fleet's and the
    single-stage oracle's. Stage telemetry reaches EngineStats and the
    MetricsBus on the way."""
    setup = _setup("qwen3-0.6b")
    got = _vf_loss(False, setup, tmp_path / "t")
    assert got == _vf_loss(True, setup, tmp_path / "j")
    assert got[1]["k_new"] == 1 and got[1]["dropped"] == ["serve0.s1"]
    assert got[2][:2] == ("running", 1) and got[2][2][0][1] == "detached"
    oracle = _fleet(False, setup, tmp_path / "o", stages=1)
    reqs = _reqs(Request)
    for r in reqs:
        oracle.submit(r)
    assert oracle.drain().drained
    assert got[0] == [list(r.out) for r in reqs]


def _budget(is_jax, setup, wd):
    out = []
    fleet = _fleet(is_jax, setup, wd / "a", num_devices=3)
    with pytest.raises((JManagerError, ManagerError), match="device budget"):
        fleet.scale_out()
    out.append((len(fleet.pool.vfs), sorted(fleet.tenants)))
    fleet = _fleet(is_jax, setup, wd / "b", num_devices=4)
    tid = fleet.scale_out()
    tn = fleet.tenants[tid]
    out.append((tid, tn.status, tn.stage_width,
                [s.status for s in tn.gang_shells], _vf_table(fleet.pool),
                _journal(fleet.mgr)))
    return out


def test_fleet_scale_out_gang_budget(tmp_path):
    """scale_out counts the K VFs a whole gang needs: 3 devices with one
    K=2 gang live refuse a second gang typed, nothing half-carved; with 4
    devices the same scale-out reconfigures to 4 VFs and gang-attaches
    whole — as the JAX fleet does."""
    setup = _setup("qwen3-0.6b")
    got = _budget(False, setup, tmp_path / "t")
    assert got == _budget(True, setup, tmp_path / "j")
    assert got[0] == (2, ["serve0"])
    assert got[1][1:4] == ("running", 2, ["running"])


def _gang_fleet(is_jax, setup, wd):
    """Two K=2 gang engines (templates to K=3) of a 4-layer deepseek-class
    model on five VFs (one free for the grow) under traffic: detach_group + attach_group of serve1,
    reshape_engine 2 -> 3 and handle_vf_loss 3 -> 2 on serve0, and a
    live pause and unpause of the lead serve0, all mid-traffic."""
    fleet = _fleet(is_jax, setup, wd, num_engines=2, num_devices=8,
                   num_vfs=5, max_stages=3)
    cls = JRequest if is_jax else Request
    reqs = _reqs(cls, n=8, new=10)
    for r in reqs[:6]:
        fleet.submit(r)
    infos = []
    for k in range(12):
        if k == 2:
            fleet.mgr.detach_group(fleet.tenants["serve1"])
            fleet.mgr.attach_group(fleet.tenants["serve1"])
        elif k == 4:
            infos.append(fleet.reshape_engine("serve0", 3))
            for r in reqs[6:]:
                fleet.submit(r)
        elif k == 6:
            tn = fleet.tenants["serve0"]
            shell = tn.gang_shells[0]
            infos.append(fleet.handle_vf_loss("serve0", shell.vf_id))
        elif k == 8:
            fleet.pause_live("serve0", rounds=2)
            infos.append(_gang_state(fleet.tenants["serve0"]))
            fleet.step()
            fleet.unpause("serve0")
        fleet.step()
    assert fleet.drain().drained
    jsim_ = jsim if is_jax else tsim
    jsim_.check_invariants(fleet.mgr)
    return ([list(r.out) for r in reqs],
            [{k: v for k, v in i.items() if k != "reshape_s"}
             if isinstance(i, dict) else i for i in infos],
            [_gang_state(fleet.tenants[t]) for t in ("serve0", "serve1")],
            _vf_table(fleet.pool), _journal(fleet.mgr))


def test_gang_fleet_ops_match_jax(tmp_path):
    """The gang fleet's ops mid-traffic give the JAX fleet's streams,
    results, gangs, VF table and journal; the streams also equal an
    undisturbed single-stage fleet's."""
    setup = _setup("deepseek-67b", 4)
    got = _gang_fleet(False, setup, tmp_path / "t")
    want = _gang_fleet(True, setup, tmp_path / "j")
    assert got == want
    assert [i["k_new"] for i in got[1][:2]] == [3, 2]
    assert got[1][1]["dropped"] == ["serve0.s1"]
    ref = _fleet(False, setup, tmp_path / "o", num_engines=2,
                 num_devices=8, stages=1)
    reqs = _reqs(Request, n=8, new=10)
    for r in reqs:
        ref.submit(r)
    assert ref.drain().drained
    assert got[0] == [list(r.out) for r in reqs]


def _autoscale_grow(is_jax, setup, wd):
    """One K=2 gang (templates to 3) with one free VF and the engine count
    maxed: a hot epoch makes the autoscaler widen the gang (the fleet's
    reshape branch). The shrink on a measured bubble reads wall clocks,
    so it is kept off here (``reshape_bubble=1``)."""
    if is_jax:
        from repro.core.autoscaler import AutoscaleConfig
    else:
        from repro_torch.core.autoscaler import AutoscaleConfig
    acfg = AutoscaleConfig(max_engines=1, hysteresis=1, cooldown=0,
                           reshape_bubble=1.0)
    fleet = _fleet(is_jax, setup, wd, num_devices=3, num_vfs=3,
                   max_stages=3, slo_max_load=4, autoscale=acfg)
    reqs = _reqs(JRequest if is_jax else Request, n=3)
    for r in reqs:
        fleet.submit(r)
    actions = []
    for _ in range(4):
        fleet.step()
        act = fleet.autoscale_step()
        if act is not None:
            (jsim if is_jax else tsim).check_autoscale(act, acfg)   # I11
            actions.append((act.kind, act.victim, act.width))
    assert fleet.drain().drained
    return ([list(r.out) for r in reqs], actions,
            _gang_state(fleet.tenants["serve0"]), _vf_table(fleet.pool),
            _journal(fleet.mgr))


def test_autoscaler_widens_a_gang_like_jax(tmp_path):
    """The fleet's autoscale step executes a grow reshape through
    ``reshape_engine``: the JAX fleet's actions, gang, VF table, journal
    and streams."""
    setup = _setup("deepseek-67b", 4)
    got = _autoscale_grow(False, setup, tmp_path / "t")
    assert got == _autoscale_grow(True, setup, tmp_path / "j")
    assert got[1][0] == ("reshape", "serve0", 3)
    assert got[2][:2] == ("running", 3)


def test_paused_gang_lead_holds_no_tensor(tmp_path):
    """A live pause of a gang lead frees its params, their compute copy,
    its pools and its stage views — with the garbage collector off, so no
    reference cycle may hold them; unpause rebuilds them."""
    fleet = _fleet(False, _setup("deepseek-67b", 4), tmp_path,
                   num_devices=4, max_stages=3)
    for r in _reqs(Request, n=3):
        fleet.submit(r)
    for _ in range(3):
        fleet.step()
    eng = fleet.tenants["serve0"].engine
    assert eng._sparams is not None
    refs = [weakref.ref(t) for t in tree_leaves(eng.params)
            + tree_leaves(eng._cparams) + tree_leaves(eng._cache)
            + [x for sp in eng._sparams for x in tree_leaves(sp)]]
    gc.disable()
    try:
        fleet.pause_live("serve0", rounds=2)
        assert not any(r() is not None for r in refs)
    finally:
        gc.enable()
    assert eng._sparams is None and eng.params is None
    fleet.unpause("serve0")
    assert fleet.drain().drained


# ===========================================================================
# the sim plane's gangs
# ===========================================================================
def test_checker_detects_gang_width_drift(tmp_path):
    """I14: a lead whose width disagrees with its running shells (a
    half-applied reshape) and a broken stage partition are both caught."""
    _, mgr = _manager(PORT, tmp_path)
    lead = tsim.SimPipelineTenant("pg0", seed=0, width=2, max_width=3,
                                  device="cpu")
    mgr.init(num_vfs=4, tenants=[])
    mgr.attach_group(lead)
    tsim.check_invariants(mgr)
    lead._width = 3                                # width moved, no shell
    with pytest.raises(tsim.InvariantViolation, match="I14"):
        tsim.check_invariants(mgr)
    lead._width = 2
    tsim.check_invariants(mgr)
    bad = lead.stage_bounds()[:-1] + (99,)         # broken partition
    lead.stage_bounds = lambda: bad
    with pytest.raises(tsim.InvariantViolation, match="I14"):
        tsim.check_invariants(mgr)


def _runner_rows(cfg_kw):
    jr = jsim.ScenarioRunner(jsim.ScenarioConfig(**cfg_kw))
    want = jr.run()
    tr = tsim.ScenarioRunner(tsim.ScenarioConfig(**cfg_kw), device="cpu")
    got = tr.run()
    assert got.fingerprint() == want.fingerprint()
    assert got.virtual_seconds == want.virtual_seconds
    assert [r.status for r in got.ops] == [r.status for r in want.ops]
    lead, jlead = tr.tenants.get("pg0"), jr.tenants.get("pg0")
    if jlead is not None:
        assert (lead.stage_width, lead.reshape_count) == \
            (jlead.stage_width, jlead.reshape_count)
        assert ([(r.rid, r.out, r.done) for r in lead.requests]
                == [(r.rid, r.out, r.done) for r in jlead.requests])
    return got, tr


@pytest.mark.parametrize("seed", [1, 4, 5])
def test_reshape_with_autoscale_interleaved(seed):
    """Reshape beside the autoscale plane (the JAX test's seeds): the JAX
    runner's fingerprint, virtual time, statuses and the gang's streams,
    with the autoscaler's history equal too."""
    got, tr = _runner_rows(dict(seed=seed, num_ops=45, serve_rate=0.3,
                                reshape_rate=0.25, autoscale_rate=0.1,
                                crash_rate=0.06, max_vfs=8))
    assert got.num_ok > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_reshape_scenarios_hold_invariants(policy):
    """Gang scenarios (reshape, serve traffic and crash ops interleaved),
    seeds 4 and 5 (``test_torch_sim.py`` runs 0-3): equal to the JAX
    runner, every non-chaos op succeeds, I14 after every op, and a replay
    gives the same fingerprint."""
    for seed in (4, 5):
        kw = dict(seed=seed, policy=policy, num_ops=45, serve_rate=0.3,
                  reshape_rate=0.25, crash_rate=0.06, max_vfs=8)
        got, _ = _runner_rows(kw)
        for r in got.ops:
            if r.status == "rejected":
                assert r.op.chaos, (seed, r.op, r.error)
        again = tsim.ScenarioRunner(tsim.ScenarioConfig(**kw),
                                    device="cpu").run()
        assert again.fingerprint() == got.fingerprint()
