"""The port's SVFF core and ServeFleet against the JAX package's.

Both packages' fleets (two engine tenants over a pool of four logical
device slots, the same weights from the JAX init, fp32 compute) run the
same operation sequence under traffic: submit, step, ``pause_live``,
arrivals while paused, ``unpause``, ``migrate``, ``reconf`` through pause
and through detach/attach, and the QMP ``device_pause``. The token
streams, the journal's (op, tenant, vf_id, status) sequence, the attach
records (apart from ``written_at``), the ``PhaseTimings`` phase names and
the pool's VF table must be equal. Then each of the slice's 11 crash
points is armed in both packages, the op crashes, ``SVFFManager.recover``
runs, and the recovered tenant statuses, VF states and journal
resolutions must be equal — and the recovered fleets must go on to serve
the same tokens.
"""
import inspect

import jax
import numpy as np
import pytest

import repro.core.fault as jfault
from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.core.manager import SVFFManager as JManager
from repro.core.qmp import ControlPlane as JControl
from repro.core.staging import StagingEngine as JStaging
from repro.models.model import build_model as jax_model
from repro.serve.engine import Request as JRequest
from repro.serve.fleet import EngineTenant as JEngineTenant
from repro.serve.fleet import ServeFleet as JFleet
import repro_torch.core.fault as tfault
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.core.manager import SVFFManager as TManager
from repro_torch.core.qmp import ControlPlane as TControl
from repro_torch.core.staging import StagingEngine as TStaging
from repro_torch.serve.engine import Request
from repro_torch.serve.fleet import EngineTenant as TEngineTenant
from repro_torch.serve.fleet import ServeFleet as TFleet

ARCH = "qwen3-0.6b"
JAX_SIDE = dict(Request=JRequest, Fleet=JFleet, Manager=JManager,
                Control=JControl, fault=jfault)
PORT_SIDE = dict(Request=Request, Fleet=TFleet, Manager=TManager,
                 Control=TControl, fault=tfault)


@pytest.fixture(scope="module")
def setup():
    jrun = jax_run_config(ARCH, "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"))
    trun = torch_run_config(ARCH, "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"))
    jp = jax_model(jrun).init(jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jrun, jp, trun, tp


@pytest.fixture(autouse=True)
def disarmed():
    yield
    jfault.crash_plane.disarm()
    tfault.crash_plane.disarm()


@pytest.mark.parametrize("cls,method", [
    ("EngineTenant", "dirty_keys"), ("EngineTenant", "inject_failure"),
    ("StagingEngine", "close")])
def test_reference_public_methods_present_with_its_signature(cls, method):
    """The reference's public methods that the ported classes lacked:
    present, with the reference's signature."""
    jcls, tcls = {"EngineTenant": (JEngineTenant, TEngineTenant),
                  "StagingEngine": (JStaging, TStaging)}[cls]
    assert inspect.signature(getattr(tcls, method)) == \
        inspect.signature(getattr(jcls, method))


def test_engine_tenant_dirty_keys_and_inject_failure(setup, tmp_path):
    """``dirty_keys`` is the engine's, as in the reference, and
    ``inject_failure`` changes nothing; the port's ``StagingEngine.close``
    is a no-op after which the engine still saves and restores."""
    sides = ((_fleet(setup, JAX_SIDE, tmp_path / "j"), JRequest),
             (_fleet(setup, PORT_SIDE, tmp_path / "t"), Request))
    got = []
    for fleet, cls in sides:
        tn = fleet.tenants["serve0"]
        fleet.submit(cls(rid=0, prompt=np.arange(5), max_new_tokens=3))
        fleet.step()
        tn.inject_failure()
        assert tn.dirty_keys() == tn.engine.dirty_keys()
        got.append(tn.dirty_keys())
        tn.export_state()
        assert tn.dirty_keys() == set()
    assert got[0] == got[1]
    eng = TStaging()
    staged = eng.save({"x": np.arange(4.0)})
    eng.close()
    eng.close()
    assert np.array_equal(eng.restore(staged, device="cpu")["x"],
                          np.arange(4.0))


def _fleet(setup, side, workdir, **kw):
    jrun, jp, trun, tp = setup
    common = dict(dict(num_engines=2, num_devices=4, slots=2, max_len=48,
                       page_size=8, workdir=str(workdir)), **kw)
    if side is JAX_SIDE:
        return JFleet(jrun, jp, **common)
    return TFleet(trun, tp, device="cpu", **common)


def _requests(cls, rids, new=6):
    """Greedy and sampled (temperature 0.8, top-k 0 or 16) requests over
    three prompt lengths."""
    return [cls(rid=i, prompt=(np.arange(5 + 3 * (i % 3)) * (i + 2) + 1)
                % 500, max_new_tokens=new,
                temperature=0.8 if i % 2 else 0.0,
                top_k=16 if i % 4 == 1 else 0, seed=3 + i) for i in rids]


def _steps(fleet, n):
    for _ in range(n):
        fleet.step()


def _vf_table(fleet):
    return [(vf.vf_id, vf.state.value, vf.owner,
             tuple(str(d) for d in vf.devices), tuple(vf.mesh_shape))
            for vf in fleet.pool.vfs.values()]


def _journal(mgr, recovered=False):
    return [(e["op"], e["tenant"], e["vf_id"], e["status"])
            + ((e["details"].get("recovered"),) if recovered else ())
            for e in mgr.journal.entries()]


def _records(mgr):
    out = {}
    for tid in mgr.records.list():
        rec = mgr.records.read(tid)
        rec.pop("written_at")
        out[tid] = rec
    return out


def _check_pool(fleet):
    """The pool's invariants: VF device sets pairwise disjoint and drawn
    from the pool, each VF's device count its mesh's (or 0), one tenant
    per attached VF, and every attached VF owned by a running tenant."""
    fleet.pool._check_invariants()
    owners = [vf.owner for vf in fleet.pool.vfs.values()
              if vf.state.value == "attached"]
    assert len(owners) == len(set(owners))
    for tid in owners:
        assert fleet.tenants[tid].status == "running"
        assert fleet.tenants[tid].vf_id in fleet.pool.vfs


def _script(side, fleet):
    """The op sequence under traffic; returns (requests, phase names)."""
    reqs = _requests(side["Request"], range(8))
    names = []
    for r in reqs[:6]:
        fleet.submit(r)
    _steps(fleet, 2)
    t = fleet.pause_live("serve0", rounds=2)
    assert t.stop_ms <= t.total * 1e3
    names.append(sorted(t.phases))
    for r in reqs[6:]:                       # arrivals while paused
        fleet.submit(r)
    _steps(fleet, 2)
    names.append(sorted(fleet.unpause("serve0").phases))
    _steps(fleet, 1)
    info = fleet.migrate("serve1")
    names.append(sorted(set(info) - {"migrate_s"}) + info["new_devices"])
    _check_pool(fleet)
    _steps(fleet, 1)
    names.append(sorted(fleet.mgr.reconf(3)))
    _check_pool(fleet)
    _steps(fleet, 2)
    names.append(sorted(fleet.mgr.reconf(3, use_pause=False)))
    _check_pool(fleet)
    _steps(fleet, 1)
    qmp = side["Control"](fleet.mgr)
    for pause in (True, False):
        res = qmp.execute({"execute": "device_pause",
                           "arguments": {"id": "serve0", "pause": pause}})
        names.append(sorted(res["return"]["timings"]))
    res = fleet.drain()
    assert res.drained
    _check_pool(fleet)
    return reqs, names


def test_fleet_op_sequence_matches_jax(setup, tmp_path):
    jf = _fleet(setup, JAX_SIDE, tmp_path / "jax")
    tf = _fleet(setup, PORT_SIDE, tmp_path / "port")
    jreqs, jnames = _script(JAX_SIDE, jf)
    treqs, tnames = _script(PORT_SIDE, tf)
    assert all(r.done and not r.error for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert tnames == jnames
    assert _journal(tf.mgr) == _journal(jf.mgr)
    assert all(e[3] == "committed" for e in _journal(tf.mgr))
    assert _records(tf.mgr) == _records(jf.mgr)
    assert _vf_table(tf) == _vf_table(jf)
    assert tf.query()["manager"]["journal_pending"] == 0


def test_pause_drops_every_device_tensor(setup, tmp_path):
    """A paused engine holds no tensor: params, their compute copy and
    the pools are freed by the pause itself — with the garbage collector
    off, so no reference cycle may hold them — the memo is cleared, the
    snapshot is host-only; unpause rebuilds them from it."""
    import gc
    import weakref
    import torch
    from repro_torch.tree import tree_leaves
    tf = _fleet(setup, PORT_SIDE, tmp_path)
    for r in _requests(Request, range(4)):
        tf.submit(r)
    _steps(tf, 2)
    eng = tf.tenants["serve0"].engine
    refs = [weakref.ref(t) for t in tree_leaves(eng.params)
            + tree_leaves(eng._cparams) + tree_leaves(eng._cache)]
    gc.disable()
    try:
        tf.pause_live("serve0", rounds=2)
        assert not any(r() is not None for r in refs)
    finally:
        gc.enable()
    assert eng.params is None and eng._cparams is None and eng._cache is None
    assert tf.mgr.staging.memo_size("serve0") == 0
    snap = tf.mgr.snapshots["serve0"]
    from repro_torch.tree import flatten
    assert all(not isinstance(x, torch.Tensor) or x.device.type == "cpu"
               for _, x in flatten(snap.payload)[0])
    tf.unpause("serve0")
    assert eng.params is not None and eng._cache is not None
    assert tf.drain().drained


def test_unported_fleet_paths_raise_naming_their_roadmap_item(setup,
                                                              tmp_path):
    """What stays refused on the elastic fleet: the federation (item 9).
    Migration, recovery, the autoscaler and the gang ops run:
    ``test_torch_migration.py``, ``test_torch_autoscaler.py``,
    ``test_torch_gang.py``."""
    tf = _fleet(setup, PORT_SIDE, tmp_path, num_engines=2)
    s0, s1 = tf.tenants["serve0"], tf.tenants["serve1"]
    for call, item in ((lambda: tf.mgr.migrate_request(s0, s1,
                                                       dst_host="host1"),
                        "item 9"),
                       (tf.federation_snapshot, "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    # the autoscaler's paths run; without a config the step is a typed
    # refusal, as in the JAX fleet
    with pytest.raises(ValueError, match="autoscale"):
        tf.autoscale_step()


def test_manager_default_workdir_is_private():
    """A manager built without a workdir keeps its journal, records and
    detach store in a fresh directory of its own, never a shared path."""
    import os
    import shutil
    import tempfile
    from repro_torch.core.pool import DevicePool
    a = TManager(DevicePool([f"slot{i}" for i in range(2)]))
    b = TManager(DevicePool([f"slot{i}" for i in range(2)]))
    try:
        assert a.workdir != b.workdir
        for m in (a, b):
            assert os.path.isdir(m.workdir)
            assert os.path.dirname(m.workdir) == tempfile.gettempdir()
            assert m.detach_store_dir.startswith(m.workdir + os.sep)
    finally:
        shutil.rmtree(a.workdir, ignore_errors=True)
        shutil.rmtree(b.workdir, ignore_errors=True)


def test_qmp_unix_socket_drives_the_port_manager(setup, tmp_path):
    """The control plane's newline-delimited JSON over a Unix socket:
    greeting, a query, a device_pause round trip, an unknown command."""
    import json
    import socket
    tf = _fleet(setup, PORT_SIDE, tmp_path, num_engines=1)
    qmp = TControl(tf.mgr)
    path = str(tmp_path / "qmp.sock")
    qmp.serve_unix(path)
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.settimeout(10)
            c.connect(path)
            f = c.makefile("rw")
            assert "device_pause" in json.loads(f.readline())["QMP"][
                "capabilities"]
            replies = []
            for req in ({"execute": "query-status"},
                        {"execute": "device_pause",
                         "arguments": {"id": "serve0"}},
                        {"execute": "device_pause",
                         "arguments": {"id": "serve0", "pause": False}},
                        {"execute": "no-such-command"}):
                f.write(json.dumps(req) + "\n")
                f.flush()
                replies.append(json.loads(f.readline()))
    finally:
        qmp.shutdown()
    assert replies[0]["return"]["journal_pending"] == 0
    assert replies[1]["return"]["status"] == "paused"
    assert replies[2]["return"]["status"] == "running"
    assert replies[3]["error"]["class"] == "CommandNotFound"


def test_launch_serve_fleet(capsys):
    """``--fleet N`` serves through a ServeFleet; ``--slo-max-load`` bounds
    each engine's load (submissions past it are rejected and retried);
    the elastic options stay refused, naming their ROADMAP item."""
    import json
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--device", "cpu", "--fleet", "2",
                     "--slo-max-load", "2", "--requests", "6",
                     "--new-tokens", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["mode"] == "fleet"
    assert out["engines_initial"] == out["engines_final"] == 2
    assert out["completed"] == out["requests"] == 6 and out["drained"]
    assert out["generated_tokens"] == 24
    assert out["rejected_submissions"] > 0 and out["journal_pending"] == 0
    assert out["autoscale_actions"] == []
    # the elastic control plane: one engine, two warm spares
    rc = serve.main(["--smoke", "--device", "cpu", "--fleet", "1",
                     "--autoscale", "--spares", "2", "--slo-max-load", "4",
                     "--requests", "16", "--new-tokens", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["completed"] == 16 and out["drained"]
    assert "scale_out" in [a["kind"] for a in out["autoscale_actions"]]
    assert out["journal_pending"] == 0


# ---------------------------------------------------------------------------
# crash points
# ---------------------------------------------------------------------------
#: crash point -> the op that runs through it
CRASH_OPS = {
    "after_snapshot_register": "pause", "after_suspend": "pause",
    "mid_pipeline_chunk": "pause", "mid_precopy_round": "pause_live",
    "before_unpause_restore": "unpause", "after_unpause_restore": "unpause",
    "after_detach_snapshot": "detach", "after_unbind": "detach",
    "mid_record_write": "attach", "after_record_write": "attach",
    "qmp_timeout": "qmp",
}


def _crash_and_recover(side, fleet, point):
    """Serve a little, crash ``point``'s op, recover the manager from what
    survives, bring every tenant back and drain. Returns (recovered
    statuses, VF table, journal resolutions, token streams)."""
    reqs = _requests(side["Request"], range(4))
    for r in reqs:
        fleet.submit(r)
    _steps(fleet, 2)
    mgr, tn = fleet.mgr, fleet.tenants["serve0"]
    op = CRASH_OPS[point]
    if op == "unpause":
        mgr.pause(tn)
    elif op == "attach":
        mgr.detach(tn)
    run = {"pause": lambda: mgr.pause(tn),
           "pause_live": lambda: fleet.pause_live("serve0"),
           "unpause": lambda: mgr.unpause(tn),
           "detach": lambda: mgr.detach(tn),
           "attach": lambda: mgr.attach(tn),
           "qmp": lambda: side["Control"](mgr).execute(
               {"execute": "device_pause", "arguments": {"id": "serve0"}}),
           }[op]
    side["fault"].crash_plane.arm(point)
    with pytest.raises(side["fault"].InjectedCrash):
        run()
    assert side["fault"].crash_plane.fired == point
    fleet.mgr = side["Manager"].recover(
        mgr.journal, fleet.pool, mgr.records, mgr.staging,
        tenants=mgr.tenants, snapshots=mgr.snapshots, workdir=mgr.workdir)
    state = ({tid: t.status for tid, t in fleet.tenants.items()},
             _vf_table(fleet), _journal(fleet.mgr, recovered=True))
    assert fleet.mgr.journal.pending() == []
    _check_pool(fleet)
    for t in fleet.tenants.values():
        if t.status == "paused":
            fleet.mgr.unpause(t)
        elif t.status == "detached":
            fleet.mgr.attach(t)
    assert fleet.drain().drained
    return state + ([r.out for r in reqs],)


@pytest.mark.parametrize("point", list(CRASH_OPS))
def test_crash_point_recovers_like_jax(setup, tmp_path, point):
    want = _crash_and_recover(JAX_SIDE, _fleet(setup, JAX_SIDE,
                                               tmp_path / "jax"), point)
    got = _crash_and_recover(PORT_SIDE, _fleet(setup, PORT_SIDE,
                                               tmp_path / "port"), point)
    assert got[0] == want[0]          # tenant statuses
    assert got[1] == want[1]          # VF table
    assert got[2] == want[2]          # journal, with each resolution
    assert got[3] == want[3]          # tokens served after recovery


def test_hybrid_fleet_matches_jax(tmp_path):
    """A fleet of two hybrid engines (the smoke twin of
    jamba-1.5-large-398b-1p-dense: paged KV beside dense per-slot conv
    and SSM state) under the port's SVFFManager, through pause_live,
    arrivals while paused, unpause and migrate: the JAX fleet's token
    streams. The staged payload carries every recurrent leaf."""
    import dataclasses
    from repro_torch.tree import flatten
    jrun = jax_run_config("jamba-1.5-large-398b", "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"))
    jrun = dataclasses.replace(
        jrun, model=dataclasses.replace(jrun.model, moe=None))
    trun = torch_run_config("jamba-1.5-large-398b-1p-dense", "decode_32k",
                            smoke=True,
                            precision=TPrecision(compute="float32"))
    jp = jax_model(jrun).init(jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    common = dict(num_engines=2, num_devices=4, slots=2, max_len=48,
                  page_size=8)

    def script(side, fleet):
        cls = side["Request"]
        reqs = [cls(rid=i, prompt=(np.arange((5, 16, 32, 9)[i % 4])
                                   * (i + 2) + 1) % 500, max_new_tokens=6,
                    temperature=0.8 if i % 2 else 0.0,
                    top_k=16 if i % 4 == 1 else 0, seed=3 + i)
                for i in range(6)]
        for r in reqs[:4]:
            fleet.submit(r)
        _steps(fleet, 2)
        fleet.pause_live("serve0", rounds=2)
        payload = fleet.mgr.snapshots["serve0"].payload
        for r in reqs[4:]:                   # arrivals while paused
            fleet.submit(r)
        _steps(fleet, 2)
        fleet.unpause("serve0")
        _steps(fleet, 1)
        fleet.migrate("serve1")
        assert fleet.drain().drained
        return reqs, payload

    jreqs, _ = script(JAX_SIDE, JFleet(jrun, jp, workdir=str(tmp_path / "j"),
                                       **common))
    tf = TFleet(trun, tp, device="cpu", workdir=str(tmp_path / "t"),
                **common)
    treqs, payload = script(PORT_SIDE, tf)
    assert all(r.done and not r.error for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    paths = [p for p, _ in flatten(payload)[0]]
    for j in (1, 2, 3):
        for name in ("conv", "ssm"):
            assert any(f"['block{j}']['{name}']" in p for p in paths), \
                (j, name)
    assert _journal(tf.mgr) and all(e[3] == "committed"
                                    for e in _journal(tf.mgr))
