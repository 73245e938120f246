"""The train tenant sharded over its VF's mesh, on the CPU: a
``repro_torch.core.ranks.RankPool`` of 4 gloo ranks (spawned processes)
against the JAX package on 4 forced host devices in one subprocess.

  constrain        on (2,2) and (1,4) meshes, every activation kind of
                   ``tests/test_torch_partitioning.py``'s grid: the
                   placements of ``rules.spec``, the values kept; the
                   identity without a mesh, on a plain tensor and for an
                   unknown kind
  train / eval     qwen3-0.6b smoke on (2,2) ("heads": 2 kv heads over a
                   model axis of 2) and (1,4) ("seq": 2 kv heads do not
                   divide 4), svff-bench smoke on (2,2): 3 steps of the
                   sharded step from JAX's init against JAX's jitted step
                   with the state and batch shardings pinned, then one
                   eval step
  scenarios        the multi-device cases of ``tests/test_core.py``
                   (pause transparency, reconf growth, reshard on
                   unpause, detach/attach via disk, QMP + Supervisor) at
                   4 devices on both sides, the same result dicts
  staging          a sharded int8 snapshot bit-equal to the unsharded
                   leaf's pack (blocks packed on their ranks, and leaves
                   gathered first); an int8 restore onto another mesh
  launch.train     a 2-rank world against one rank

Tolerances, each with its reason:
  losses, grad norms, eval  1e-5 absolute (relative above 1), the
                   five-step parity test's bound: the same fp32 math,
                   summed in other orders across the ranks
  params           1e-3 absolute after three AdamW steps at lr 1e-2 (a
                   tenth of a step), as ``test_train_steps_track_jax``:
                   Adam divides by sqrt(v), so a rounding difference
                   where a gradient element is near zero turns its step
  pause, reshard   bit-equal: the same bytes moved
  int8 restore     max|a| / 64 per leaf (``tests/test_staging.py``)
  launch.train     1e-3 absolute on the loss (~6.25), bf16 compute: the
                   sharded matmuls and the gradients' sums run in other
                   orders and round to bf16 at other points (read:
                   1.4e-4 at the third step)
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import MeshConfig
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config
from repro_torch.core import (ControlPlane, DevicePausedError, DevicePool,
                              StagingEngine, SVFFManager, Supervisor, Tenant)
from repro_torch.core.ranks import RankPool, RankShardings
from repro_torch.core.staging import QuantizedLeaf
from repro_torch.data.pipeline import SyntheticSource
from repro_torch.kernels.ref import qdma_pack_ref
from repro_torch.runtime.partitioning import ShardingRules
from repro_torch.train.step import init_train_state, train_state_specs
from repro_torch.tree import flatten

import spmd_cases

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
AXES = ("data", "model")
TRAIN_CASES = [("qwen3-0.6b", (2, 2)), ("qwen3-0.6b", (1, 4)),
               ("svff-bench", (2, 2))]
OPT = dict(lr=1e-2, warmup=2)

# ---------------------------------------------------------------------------
# the JAX side: one subprocess, 4 forced host devices
# ---------------------------------------------------------------------------
JAX_HEAD = textwrap.dedent("""
    import os, sys, json, pickle, tempfile, socket
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    jax.config.update("jax_threefry_partitionable", True)
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import (MeshConfig, OptimizerConfig,
                               PrecisionConfig, make_run_config)
    from repro.core import (ControlPlane, DevicePausedError, DevicePool,
                            SVFFManager, Supervisor, Tenant)
    from repro.data.pipeline import SyntheticSource
    from repro.runtime.partitioning import ShardingRules
    from repro.train.step import (init_train_state, make_eval_step,
                                  make_train_step, train_state_specs)
    out_path, cases = sys.argv[1], json.loads(sys.argv[2])
    out = {"train": {}, "scen": {}}
    for arch, shape in cases:
        shape = tuple(shape)
        run = make_run_config(arch, "train_4k", smoke=True,
                              precision=PrecisionConfig(compute="float32"),
                              optimizer=OptimizerConfig(lr=1e-2, warmup=2))
        mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(
            shape), ("data", "model"))          # as VirtualFunction.mesh
        rules = ShardingRules(MeshConfig(shape, ("data", "model")), run,
                              mesh)
        state = init_train_state(run, jax.random.key(0))
        init = jax.tree.map(np.asarray, state)
        sshard = rules.named(train_state_specs(run, rules))
        src = SyntheticSource(run, batch_override=4, seq_override=16)
        bspecs = rules.named({
            k: P(rules._fit(v.shape[0], rules.dp_axes),
                 *([None] * (v.ndim - 1)))
            for k, v in src.batch_at(0).items()})
        step = jax.jit(make_train_step(run, rules),
                       in_shardings=(sshard, bspecs),
                       out_shardings=(sshard, None))
        state = jax.device_put(state, sshard)
        metrics = []
        for i in range(3):
            b = {k: jax.device_put(v, bspecs[k])
                 for k, v in src.batch_at(i).items()}
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        ev = jax.jit(make_eval_step(run, rules))(
            state["params"], {k: jax.device_put(v, bspecs[k])
                              for k, v in src.batch_at(7).items()})
        out["train"][f"{arch}|{shape}"] = {
            "init": init, "metrics": metrics,
            "final": jax.tree.map(np.asarray, state),
            "eval": {k: float(v) for k, v in ev.items()}}

    run = make_run_config("svff-bench", "train_4k", smoke=True)
    DEVICES, KW = None, {}


    def leaf(tn):
        return np.asarray(
            jax.tree.leaves(tn.export_state()["params"])[1]).copy()


""")
JAX_TAIL = textwrap.dedent("""
    for name, fn in list(globals().items()):
        if name.startswith("scen_"):
            out["scen"][name[5:]] = fn(tempfile.mkdtemp(prefix="svff_"))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
""")

# The tests/test_core.py multi-device bodies at 4 devices (8 there), as
# functions of a manager factory: the JAX subprocess runs them with JAX's
# classes, the tests with the port's on a rank pool.
SCENARIOS = {
    "pause_transparency": """
        pool = DevicePool(DEVICES)
        mgr = SVFFManager(pool, workdir=WORKDIR)
        tn = Tenant('vm0', run, local_batch=2, seq_len=16, **KW)
        mgr.init(num_vfs=2, tenants=[tn], devices_per_vf=2)
        tn.run_steps(2)
        before = leaf(tn)
        nexec = len(tn._exec_cache)
        mgr.pause(tn)
        visible = tn.query()
        blocked = False
        try:
            tn.run_steps(1)
        except DevicePausedError:
            blocked = True
        mgr.unpause(tn)
        after = leaf(tn)
        tn.run_steps(1)
        return {
            'visible_while_paused': visible['status'] == 'paused',
            'vf_kept_identity': visible['vf'] is not None,
            'io_blocked': blocked,
            'state_identical': bool((before == after).all()),
            'exec_cache_hit': len(tn._exec_cache) == nexec,
            'steps_after': tn.steps_done,
        }
    """,
    "reconf_growth": """
        pool = DevicePool(DEVICES)
        mgr = SVFFManager(pool, workdir=WORKDIR)
        a = Tenant('vmA', run, local_batch=2, seq_len=16, seed=1, **KW)
        mgr.init(num_vfs=1, tenants=[a], devices_per_vf=4)
        a.run_steps(2)
        sA = leaf(a)
        b = Tenant('vmB', run, local_batch=2, seq_len=16, seed=2, **KW)
        mgr.tenants['vmB'] = b
        t = mgr.reconf(num_vfs=2, new_tenants=[b], devices_per_vf=2)
        a.run_steps(1); b.run_steps(1)
        sA2 = leaf(a)
        return {
            'timings_keys': sorted(t.keys()),
            'a_steps': a.steps_done, 'b_steps': b.steps_done,
            'a_continued': bool(sA2.shape == sA.shape),
            'a_mesh': list(pool.find(a.vf_id).mesh_shape),
        }
    """,
    "reshard_on_unpause": """
        pool = DevicePool(DEVICES)
        mgr = SVFFManager(pool, workdir=WORKDIR)
        tn = Tenant('vm0', run, local_batch=2, seq_len=16, **KW)
        mgr.init(num_vfs=2, tenants=[tn], devices_per_vf=2)
        tn.run_steps(1)
        before = leaf(tn)
        mgr.pause(tn)
        pool.set_num_vfs(1, devices_per_vf=4)
        mgr.unpause(tn, num_devices=4)
        same = bool((leaf(tn) == before).all())
        tn.run_steps(1)
        return {
            'new_mesh': list(pool.find(tn.vf_id).mesh_shape),
            'steps': tn.steps_done, 'state_identical': same,
        }
    """,
    "detach_attach_via_disk": """
        pool = DevicePool(DEVICES)
        mgr = SVFFManager(pool, workdir=WORKDIR)
        tn = Tenant('vm0', run, local_batch=2, seq_len=16, **KW)
        mgr.init(num_vfs=2, tenants=[tn], devices_per_vf=2)
        tn.run_steps(2)
        w = leaf(tn)
        mgr.detach(tn)
        detached = tn.status == 'detached' and tn.vf_id is None
        mgr.attach(tn)
        w2 = leaf(tn)
        tn.run_steps(1)
        return {
            'detached': detached,
            'state_identical': bool((w == w2).all()),
            'steps': tn.steps_done,
        }
    """,
    "qmp_and_supervisor": """
        pool = DevicePool(DEVICES)
        mgr = SVFFManager(pool, workdir=WORKDIR)
        t0 = Tenant('vm0', run, local_batch=2, seq_len=16, **KW)
        mgr.init(num_vfs=2, tenants=[t0], devices_per_vf=2)
        cp = ControlPlane(mgr)
        cp.serve_unix(WORKDIR + '/qmp.sock')
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(WORKDIR + '/qmp.sock')
        f = s.makefile('rw')
        greeting = json.loads(f.readline())
        f.write(json.dumps({'execute': 'query-vfs'}) + '\\n'); f.flush()
        vfs = json.loads(f.readline())
        f.write(json.dumps({'execute': 'device_pause',
                            'arguments': {'id': 'vm0'}}) + '\\n'); f.flush()
        pz = json.loads(f.readline())
        f.write(json.dumps({'execute': 'device_pause',
                            'arguments': {'id': 'vm0', 'pause': False}})
                + '\\n'); f.flush()
        upz = json.loads(f.readline())
        s.close()
        cp.shutdown()
        sup = Supervisor(mgr)
        t0.inject_failure()
        sup.run_round(1)
        t0.run_steps(1)
        return {
            'greeting': 'QMP' in greeting,
            'nvfs': vfs['return']['num_vfs'],
            'pause_ok': 'return' in pz, 'unpause_ok': 'return' in upz,
            'events': [e['kind'] for e in sup.events],
            'recovered_steps': t0.steps_done,
        }
    """,
}


def _scenario_source() -> str:
    return "".join(f"def scen_{name}(WORKDIR):\n"
                   + textwrap.indent(textwrap.dedent(body), "    ") + "\n"
                   for name, body in SCENARIOS.items())


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Every JAX reference of this file, from one subprocess."""
    path = tmp_path_factory.mktemp("jax_ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", JAX_HEAD + _scenario_source() + JAX_TAIL,
         str(path), json.dumps(TRAIN_CASES)],
        capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks():
    with RankPool(4, device="cpu") as rp:
        yield rp


def _run(arch, **kw):
    return make_run_config(arch, "train_4k", smoke=True,
                           precision=TPrecision(compute="float32"),
                           optimizer=TOpt(**OPT), **kw)


def _flat(tree) -> dict:
    return {p: (x.detach().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x)) for p, x in flatten(tree)[0]}


def _shardings(rp, run, shape, tid, ranks=None):
    mesh = rp.mesh(shape, AXES, ranks or rp.ranks[:int(np.prod(shape))])
    rules = ShardingRules(MeshConfig(shape, AXES), run)
    return RankShardings(mesh, run, train_state_specs(run, rules), tid)


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sp", [False, True], ids=["plain", "sp"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_constrain_lays_out_every_kind_as_its_spec(ranks, shape, sp):
    from repro_torch.configs import ShardingConfig
    run = make_run_config("qwen3-0.6b", "train_4k", smoke=True,
                          sharding=ShardingConfig(seq_shard_acts=sp))
    mesh = ranks.mesh(shape, AXES, ranks.ranks)
    bad = ranks.run_on(ranks.ranks, spmd_cases.constrain_layouts, mesh.key,
                       run)
    assert bad == [[]] * 4


def test_gloo_card_routes_give_the_functional_collectives(ranks):
    """The synchronous gloo calls that stand in for DTensor's functional
    collectives on a card's tensors, run on the CPU over 4 ranks, give
    the functional collectives' results exactly."""
    got = ranks.run_on(ranks.ranks, spmd_cases.gloo_routes)
    assert all(v == 0.0 for res in got for v in res.values()), got


# ---------------------------------------------------------------------------
# the sharded train and eval steps against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", TRAIN_CASES)
def test_sharded_train_and_eval_steps_track_jax(ranks, jax_ref, arch, shape):
    ref = jax_ref["train"][f"{arch}|{shape}"]
    run = _run(arch)
    rules = ShardingRules(MeshConfig(shape, AXES), run)
    assert rules.attn_mode(run.model.num_heads) == (
        "seq" if shape == (1, 4) else "heads")
    start = interop.train_state_from_jax(ref["init"], device="cpu")
    rs = _shardings(ranks, run, shape, "parity").place(_flat(start))
    src = SyntheticSource(run, batch_override=4, seq_override=16)
    done = rs.step([src.batch_at(i) for i in range(3)])
    for (got, _), want in zip(done, ref["metrics"]):
        assert set(got) == set(want)
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k
    ev = rs.eval(src.batch_at(7))
    assert abs(ev["loss"] - ref["eval"]["loss"]) <= 1e-5
    final = rs.gather()
    want = _flat(interop.train_state_from_jax(ref["final"], device="cpu"))
    assert final.keys() == want.keys()
    for path in want:
        got = final[path].to(torch.float32).numpy()
        assert np.abs(got - want[path].astype(np.float32)).max() <= 1e-3, \
            path
    # each rank holds its blocks only, as the specs give them
    sizes = rs.shardings.local_bytes()
    assert {r: m[0] for r, m in rs.memory().items()} == sizes
    total = sum(x.nbytes for x in want.values())
    assert all(n < total for n in sizes.values())
    rs.release()


# ---------------------------------------------------------------------------
# the tests/test_core.py multi-device scenarios on a rank pool
# ---------------------------------------------------------------------------
def _port_scenarios(rp):
    env = {"DevicePool": DevicePool, "SVFFManager": SVFFManager,
           "Tenant": Tenant, "DevicePausedError": DevicePausedError,
           "ControlPlane": ControlPlane, "Supervisor": Supervisor,
           "json": json, "socket": socket, "np": np,
           "DEVICES": rp.ranks, "KW": {"device": "cpu"},
           "run": make_run_config("svff-bench", "train_4k", smoke=True)}
    env["leaf"] = lambda tn: [
        x for p, x in tn.export_state().gather().items()
        if p.startswith("['params']")][1].numpy().copy()
    exec(_scenario_source(), env)
    return env


EXPECTED = {
    "pause_transparency": {
        "visible_while_paused": True, "vf_kept_identity": True,
        "io_blocked": True, "state_identical": True,
        "exec_cache_hit": True, "steps_after": 3},
    "detach_attach_via_disk": {"detached": True, "state_identical": True,
                               "steps": 3},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_core_multi_device_scenarios_on_a_rank_pool(ranks, jax_ref, name,
                                                    tmp_path):
    env = _port_scenarios(ranks)
    got = env[f"scen_{name}"](str(tmp_path))
    want = jax_ref["scen"][name]
    assert got == want
    if name in EXPECTED:
        assert got == EXPECTED[name]
    if name == "reconf_growth":
        assert got["timings_keys"] == ["add_vf", "change_num_vf",
                                       "remove_vf", "rescan", "total"]
        assert got["a_steps"] == 3 and got["b_steps"] == 1
    if name == "reshard_on_unpause":
        assert got == {"new_mesh": [2, 2], "steps": 2,
                       "state_identical": True}
    if name == "qmp_and_supervisor":
        assert got["events"] == ["failure", "migrated"]


def test_paused_tenant_holds_no_tensor_on_any_rank(ranks, tmp_path):
    """After pause and after detach no worker holds the tenant's
    tensors; the unpause onto a (2,2) mesh continues bit-identically
    from the paused state, as the twin on one device does."""
    run = _run("svff-bench")
    pool = DevicePool(ranks.ranks)
    mgr = SVFFManager(pool, workdir=str(tmp_path))
    tn = Tenant("held", run, local_batch=4, seq_len=16, device="cpu")
    mgr.init(num_vfs=2, tenants=[tn], devices_per_vf=2)
    tn.run_steps(2)
    before = tn.export_state().gather()
    assert "held" in sum(ranks.run_on(ranks.ranks[:2],
                                      spmd_cases.tenants_held), [])
    mgr.pause(tn)
    assert not any("held" in h for h in ranks.run_on(
        ranks.ranks, spmd_cases.tenants_held))
    pool.set_num_vfs(1, devices_per_vf=4)
    mgr.unpause(tn, num_devices=4)
    assert pool.find(tn.vf_id).mesh_shape == (2, 2)
    after = tn.export_state().gather()
    assert all(torch.equal(before[k], after[k]) for k in before)
    losses = [tn.run_steps(1)["loss"] for _ in range(2)]
    twin = Tenant("twin", run, local_batch=4, seq_len=16, device="cpu")
    SVFFManager(DevicePool(["slot0"]), workdir=str(tmp_path / "twin")).init(
        num_vfs=1, tenants=[twin])
    want = [twin.run_steps(1)["loss"] for _ in range(4)][2:]
    np.testing.assert_allclose(losses, want, atol=1e-5, rtol=0)
    mgr.detach(tn)
    assert not any("held" in h for h in ranks.run_on(
        ranks.ranks, spmd_cases.tenants_held))


def test_place_hands_each_member_its_blocks_alone(ranks, monkeypatch):
    """A restore places one member at a time (a place is no collective),
    so the controller holds one member's blocks at once; the placed state
    equals the host state."""
    run = _run("svff-bench")
    start = init_train_state(run, 0, "cpu")
    calls = []
    call = RankPool.call

    def spy(self, rs, op, *args, **kw):
        if op == "place":
            calls.append(list(rs))
        return call(self, rs, op, *args, **kw)
    monkeypatch.setattr(RankPool, "call", spy)
    rs = _shardings(ranks, run, (2, 2), "alone").place(_flat(start))
    try:
        assert calls == [[0], [1], [2], [3]]
        got = rs.gather()
        assert all(torch.equal(got[p], x) for p, x in flatten(start)[0])
    finally:
        rs.release()


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------
def test_sharded_int8_snapshot_is_the_unsharded_pack(ranks):
    """Block 64 on qwen3-0.6b smoke over (2,2): a leaf whose block's last
    dim is 64 packs on its ranks, one whose block's last dim is 32 is
    gathered and packed whole; both give the unsharded pack bit for bit.
    The int8 restore onto (1,4) lies within max|a|/64 of each leaf."""
    run = _run("qwen3-0.6b")
    state = init_train_state(run, 3, "cpu")
    flat = _flat(state)
    rs = _shardings(ranks, run, (2, 2), "int8").place(
        {p: torch.from_numpy(a) for p, a in flat.items()})
    eng = StagingEngine(compression="int8", block=64, min_quant_size=64)
    snap = eng.save(rs)
    host = {p: getattr(x, "leaf", x)
            for p, x in flatten(snap, is_leaf=lambda x: hasattr(
                x, "leaf"))[0]}
    packed = {p for p, x in host.items() if isinstance(x, QuantizedLeaf)}
    owners = rs.shardings.owners()
    local_last = {p: next(iter(owners[p].values()))[-1] for p in packed}
    gathered = {p for p in packed
                if (local_last[p].stop - local_last[p].start) % 64}
    assert gathered and packed - gathered
    for p in packed:
        q, scale = qdma_pack_ref(torch.from_numpy(flat[p]), block=64)
        assert torch.equal(host[p].q, q) and torch.equal(host[p].scale,
                                                         scale), p
    for p in set(host) - packed:
        assert torch.equal(host[p], torch.from_numpy(flat[p])), p
    rs.release()
    back = eng.restore(snap, _shardings(ranks, run, (1, 4), "int8"))
    full = back.gather()
    for p, a in flat.items():
        err = np.abs(full[p].numpy() - a).max()
        assert err <= np.abs(a).max() / 64 + 1e-12, p
    back.release()


def test_sharded_incremental_save_reuses_unchanged_leaves(ranks):
    """With dirty tracking the blocks' digests come first: a second save
    of an unchanged sharded state moves no byte, and after a step the
    snapshot is the new state's."""
    run = _run("svff-bench")
    rs = _shardings(ranks, run, (2, 2), "inc").place(
        _flat(init_train_state(run, 5, "cpu")))
    eng = StagingEngine(incremental=True, dirty="digest")
    eng.save(rs, tenant="inc")
    first = eng.last_stats
    eng.save(rs, tenant="inc")
    again = eng.last_stats
    assert first.skipped_bytes == 0 and first.bytes_moved > 0
    assert again.bytes_moved == 0 and again.skipped_bytes == \
        first.bytes_moved
    rs.step([SyntheticSource(run, batch_override=4,
                             seq_override=16).batch_at(0)])
    snap = eng.save(rs, tenant="inc")
    host = dict(flatten(snap)[0])
    assert all(torch.equal(host[p], x) for p, x in rs.gather().items())
    rs.release()


# ---------------------------------------------------------------------------
# launch.train over a world of ranks
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(workdir, world: int):
    args = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--smoke", "--steps", "3", "--batch", "4", "--seq", "16",
            "--lr", "1e-2", "--warmup", "2", "--checkpoint-every", "0",
            "--workdir", str(workdir)]
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        if world > 1:
            env.update(RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), [l[-2000:] for l in logs]
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_launch_train_on_two_ranks_matches_one(tmp_path):
    one = _launch(tmp_path / "one", 1)
    two = _launch(tmp_path / "two", 2)
    assert [m["step"] for m in two] == [m["step"] for m in one] == [1, 2, 3]
    for a, b in zip(one, two):
        assert abs(a["loss"] - b["loss"]) <= 1e-3
        assert a["lr"] == b["lr"]
    # rank 0 alone wrote the full-value checkpoint, readable on one rank
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.train.step import train_state_shapes
    run = make_run_config("qwen3-0.6b", "train_4k", smoke=True)
    store = CheckpointStore(str(tmp_path / "two" / "ckpt"))
    assert store.steps() == [3]
    state = store.restore(3, train_state_shapes(run))
    assert int(state["step"]) == 3


def test_launch_train_alone_trains_on_one_card(monkeypatch):
    """A process alone (no world) trains on one card whatever the host
    holds: with two cards ``local_mesh_config`` counts them, and
    ``build`` still gives the unit mesh and no rules."""
    import torch.distributed as dist

    from repro_torch.configs import UNIT_MESH
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert not dist.is_initialized()
    assert tmesh.local_mesh_config("cuda").shape == (2, 1)
    run, rules = launch.build(launch.parser().parse_args(
        ["--smoke", "--device", "cuda"]))
    assert rules is None and run.mesh == UNIT_MESH
