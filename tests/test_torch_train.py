"""The port's training path against the JAX package's, on the CPU at
smoke sizes: the optimizers, the learning-rate schedule and clipping, the
synthetic data, the loss and its gradients (qwen3-0.6b smoke, svff-bench
and the hybrid's smoke twin), remat, ``make_train_step`` over several
steps, the train ``Tenant`` under ``SVFFManager`` beside the JAX
``Tenant`` under ``repro.core.SVFFManager``, ``launch.train`` and the
Table I/II benchmarks. Both packages start from the same state: the JAX init,
converted by ``repro_torch.interop``.

Tolerances, each with its reason:
  optimizers, schedule,  1e-6 relative (of each leaf's max): the same fp32
  clipping               operations, with other rsqrt/pow approximations
                         and fusions (an FMA rounds once where two ops
                         round twice)
  data                   byte-equal: both draw with numpy from one seed
  loss, ce (fp32)        1e-5 absolute on ~6: fp32 sums in other orders
  gradients (fp32)       1e-5 of each leaf's max |grad|: the same, through
                         two layers and their backward
  loss (bf16 compute)    2e-2 absolute, gradients 5e-2 of each leaf's max:
                         activations round to bf16 after every matmul, a
                         value on a rounding boundary lands one bf16 step
                         apart, and the port's plain attention keeps the
                         probabilities in fp32 where JAX's attention_ref
                         rounds them to bf16 before PV
  train steps (fp32)     losses, grad norms 1e-5 (relative above 1);
                         params 1e-3 absolute after five AdamW steps at
                         lr 1e-2, a tenth of one step: Adam divides by
                         sqrt(v), so where a gradient element is near zero
                         a rounding difference turns its step (read:
                         1.8e-4 with microbatch 2)
  hybrid (fp32)          loss 1e-5, gradients 1e-4 of each leaf's max: the
                         plain chunked scan and JAX's ssd_chunked sum in
                         other orders over the chunk
  remat, pause, resume   bit-equal: the same computation on the same bytes
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOpt
from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.core import DevicePool as JPool
from repro.core import SVFFManager as JManager
from repro.core import Tenant as JTenant
from repro.core.tenant import DevicePausedError as JPaused
from repro.data.pipeline import HostShard as JShard
from repro.data.pipeline import SyntheticSource as JSource
from repro.models.model import build_model as jax_model
from repro.train import optim as joptim
from repro.train.step import init_train_state as jax_init_state
from repro.train.step import make_train_step as jax_train_step
from repro_torch import interop
from repro_torch.configs import OptimizerConfig as TOpt
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.core import DevicePausedError, DevicePool, SVFFManager
from repro_torch.core import Tenant
from repro_torch.data.pipeline import HostShard, SyntheticSource, to_device
from repro_torch.kernels import ops as kops
from repro_torch.models.model import build_model as torch_model
from repro_torch.train import optim as toptim
from repro_torch.train.step import (init_train_state, make_eval_step,
                                    make_train_step, train_state_shapes)
from repro_torch.tree import tree_items, tree_map

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HYBRID_JAX = "jamba-1.5-large-398b"
HYBRID = "jamba-1.5-large-398b-1p-dense"


def _runs(arch, compute="float32", **kw):
    """The JAX and port RunConfigs of ``arch``'s smoke config (the hybrid:
    the JAX smoke config with ``moe=None``, as tests/test_torch_ssm.py
    builds it)."""
    jarch = HYBRID_JAX if arch == HYBRID else arch
    jkw = dict(kw)
    if "optimizer" in jkw:
        jkw["optimizer"] = JOpt(**dataclasses.asdict(jkw["optimizer"]))
    jrun = jax_run_config(jarch, "train_4k", smoke=True,
                          precision=JPrecision(compute=compute), **jkw)
    if arch == HYBRID:
        jrun = dataclasses.replace(
            jrun, model=dataclasses.replace(jrun.model, moe=None))
    trun = torch_run_config(arch, "train_4k", smoke=True,
                            precision=TPrecision(compute=compute), **kw)
    return jrun, trun


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree) -> dict:
    return {p: (t.detach().to(torch.float32).numpy()
                if isinstance(t, torch.Tensor) else np.asarray(t))
            for p, t in tree_items(tree)}


def _batch(vocab, B=2, S=16, seed=0, invalid=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if invalid:
        labels[0, 3] = labels[-1, -1] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# optimizers, schedule, clipping
# ---------------------------------------------------------------------------
def _opt_tree(seed):
    """A param tree with a stacked (periods, in, out) matrix, a matrix,
    vectors and a (1, n) row (not factored by Adafactor)."""
    rng = np.random.default_rng(seed)
    return {"layers": {"w": rng.standard_normal((2, 8, 12), np.float32),
                       "norm": rng.standard_normal((2, 8), np.float32)},
            "emb": rng.standard_normal((16, 8), np.float32),
            "row": rng.standard_normal((1, 5), np.float32),
            "bias": rng.standard_normal((7,), np.float32)}


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_update_matches_jax(name):
    cfg = dict(name=name, lr=1e-2, warmup=2, weight_decay=0.1)
    jopt = joptim.build_optimizer(JOpt(**cfg))
    topt = toptim.build_optimizer(TOpt(**cfg))
    params = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = interop.params_from_jax(params, device="cpu")
    ts = interop.train_state_from_jax(_np(js), device="cpu")
    for i in range(3):
        grads = _opt_tree(10 + i)
        lr = 1e-2 * (i + 1) / 3
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp,
                             jnp.float32(lr))
        tp, ts = topt.update(interop.params_from_jax(grads, device="cpu"),
                             ts, tp, torch.tensor(lr, dtype=torch.float32))
    want, got = _leaves(_np(jp)), _leaves(tp)
    for path in want:
        assert _rel(got[path], want[path]) <= 1e-6, path
    want, got = _leaves(_np(js)), _leaves(ts)
    assert want.keys() == got.keys()
    for path in want:
        assert _rel(got[path], want[path]) <= 1e-6, path


def test_schedule_and_clip_match_jax():
    for warmup, total in ((5, 30), (100, 10000), (0, 1)):
        cfg = dict(lr=3e-3, warmup=warmup)
        jl = joptim.lr_schedule(JOpt(**cfg), total)
        tl = toptim.lr_schedule(TOpt(**cfg), total)
        for step in (0, 1, warmup, warmup + 1, total // 2, total, total + 3):
            want = float(jl(jnp.int32(step)))
            assert abs(float(tl(torch.tensor(step, dtype=torch.int32)))
                       - want) <= 1e-6 * want, (warmup, total, step)
    for scale in (1e-3, 10.0):              # under and over the clip norm
        grads = jax.tree.map(lambda a: a * scale, _opt_tree(3))
        jg, jn = joptim.clip_by_global_norm(
            jax.tree.map(jnp.asarray, grads), 1.0)
        tg, tn = toptim.clip_by_global_norm(
            interop.params_from_jax(grads, device="cpu"), 1.0)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        want, got = _leaves(_np(jg)), _leaves(tg)
        for path in want:
            assert _rel(got[path], want[path]) <= 1e-6, path


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "svff-bench"])
def test_synthetic_batches_byte_equal(arch):
    for seed in (0, 3, 12345):
        jrun, trun = _runs(arch, seed=seed)
        for shard in (JShard(0, 1), JShard(1, 2)):
            js = JSource(jrun, shard=shard, batch_override=4,
                         seq_override=24)
            ts = SyntheticSource(trun, shard=HostShard(shard.index,
                                                       shard.count),
                                 batch_override=4, seq_override=24)
            for step in (0, 1, 7, 1000):
                want, got = js.batch_at(step), ts.batch_at(step)
                assert want.keys() == got.keys()
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    assert np.array_equal(got[k], want[k]), (seed, step, k)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
def _grads_both(arch, compute, batch):
    jrun, trun = _runs(arch, compute)
    jp = jax_model(jrun).init(jax.random.key(0))
    (jl, jm), jg = jax.jit(jax.value_and_grad(jax_model(jrun).loss,
                                              has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    tp = tree_map(lambda t: t.requires_grad_(True),
                  interop.params_from_jax(_np(jp), device="cpu"))
    tl, tm = torch_model(trun).loss(tp, _tb(batch))
    tl.backward()
    return (jl, jm, _leaves(_np(jg))), (tl, tm, {p: t.grad.numpy() for p, t
                                                 in tree_items(tp)})


@pytest.mark.parametrize("arch,compute", [
    ("qwen3-0.6b", "float32"), ("svff-bench", "float32"),
    ("qwen3-0.6b", "bfloat16"), ("svff-bench", "bfloat16"),
    (HYBRID, "float32")])
def test_loss_and_grads_match_jax(arch, compute):
    """Loss, ce, ntok and every gradient, with two labels at -1."""
    batch = _batch(512, S=32 if arch == HYBRID else 16)
    (jl, jm, jg), (tl, tm, tg) = _grads_both(arch, compute, batch)
    exact = compute == "float32"
    loss_tol = 1e-5 if exact else 2e-2
    grad_tol = (1e-4 if arch == HYBRID else 1e-5) if exact else 5e-2
    assert abs(float(tl.detach()) - float(jl)) <= loss_tol
    assert abs(float(tm["ce"].detach()) - float(jm["ce"])) <= loss_tol
    assert int(tm["ntok"]) == int(jm["ntok"]) == batch["labels"].size - 2
    assert set(tm) == set(jm)
    assert jg.keys() == tg.keys()
    for path in jg:
        assert _rel(tg[path], jg[path]) <= grad_tol, path


def test_remat_gives_bit_equal_gradients():
    _, trun = _runs("qwen3-0.6b")
    params = torch_model(trun).init(seed=1, device="cpu")
    batch = _tb(_batch(512))
    out = {}
    for remat in ("none", "dots", "full"):
        run = trun.replace(sharding=dataclasses.replace(trun.sharding,
                                                        remat=remat))
        step = make_train_step(run)
        state = init_train_state(run, seed=1, device="cpu")
        state["params"] = tree_map(torch.clone, params)
        state, m = step(state, batch)
        out[remat] = (float(m["loss"]), _leaves(state["params"]))
    for remat in ("dots", "full"):
        assert out[remat][0] == out["none"][0]
        for path, x in out["none"][1].items():
            assert np.array_equal(out[remat][1][path], x), (remat, path)


def test_train_mode_never_launches_kernels_under_autograd(monkeypatch):
    """With grad on, the train forward takes the plain attention and scan
    (backend "ref") even with ``kernel_backend="auto"``; under no_grad the
    eval step asks the wrappers (which on CPU tensors run the plain
    versions). The wrappers refuse a launch under autograd."""
    _, trun = _runs(HYBRID)
    assert trun.kernel_backend == "auto"
    model = torch_model(trun)
    params = model.init(seed=0, device="cpu")
    batch = _tb(_batch(512, S=32))
    asked = []
    real = {n: getattr(kops, n) for n in ("flash_attention", "ssm_scan")}

    def spy(name):
        def call(*a, backend="auto", **k):
            if torch.is_grad_enabled() and backend != "ref":
                raise AssertionError(f"{name} asked for a kernel under "
                                     "autograd")
            asked.append((name, backend))
            return real[name](*a, backend=backend, **k)
        return call
    for name in real:
        monkeypatch.setattr(kops, name, spy(name))
    state = init_train_state(trun, seed=0, device="cpu")
    make_train_step(trun)(state, batch)
    assert asked and all(b == "ref" for _, b in asked)
    asked.clear()
    make_eval_step(trun)(params, batch)
    assert {n for n, b in asked if b == "auto"} == set(real)
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kops._no_autograd("flash_attention", x)
    with torch.no_grad():
        kops._no_autograd("flash_attention", x)


def test_eval_step_equals_train_mode_loss():
    _, trun = _runs("qwen3-0.6b")
    state = init_train_state(trun, seed=2, device="cpu")
    batch = _tb(_batch(512))
    ev = make_eval_step(trun)(state["params"], batch)
    loss, m = torch_model(trun).loss(state["params"], batch)
    assert float(ev["loss"]) == float(loss) and float(ev["ce"]) == float(
        m["ce"])


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,microbatch", [("qwen3-0.6b", 1),
                                             ("svff-bench", 2)])
def test_train_steps_track_jax(arch, microbatch):
    opt = dict(lr=1e-2, warmup=2)
    jrun, trun = _runs(arch, microbatch=microbatch, optimizer=TOpt(**opt))
    jstate = jax_init_state(jrun, jax.random.key(0))
    tstate = interop.train_state_from_jax(_np(jstate), device="cpu")
    jstep = jax.jit(jax_train_step(jrun, total_steps=20))
    tstep = make_train_step(trun, total_steps=20)
    src = SyntheticSource(trun, batch_override=4, seq_override=16)
    for i in range(5):
        batch = src.batch_at(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, _tb(batch))
        assert set(tm) == set(jm)
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(
                1.0, abs(float(jm[k]))), (i, k)
    assert int(tstate["step"]) == int(jstate["step"]) == 5
    want, got = _leaves(_np(jstate)), _leaves(tstate)
    assert want.keys() == got.keys()
    for path in want:
        assert np.abs(got[path] - want[path]).max() <= 1e-3, path


def test_full_vocab_steps_track_jax():
    """qwen3-0.6b's smoke depth at its full vocabulary (151,936), 15 steps
    of 2 x 32 at lr 3e-3 (the JAX launch test's rate): the losses track
    JAX's within 1e-4 (read: 4.2e-5), and in both packages the last five
    steps' mean loss lies above the first five's. At this vocabulary a
    batch sees each token about once, so the synthetic sequences are not
    learnable in a few steps, and an AdamW step of 3e-3 overwrites the
    tied embedding (init std 1/sqrt(151936) = 2.6e-3): the reason
    chip_smoke.py trains the full-width model at lr 1e-4."""
    vocab = 151_936
    jrun, trun = _runs("qwen3-0.6b", optimizer=TOpt(lr=3e-3, warmup=5))
    jrun = dataclasses.replace(jrun, model=dataclasses.replace(
        jrun.model, vocab_size=vocab))
    trun = trun.replace(model=dataclasses.replace(trun.model,
                                                  vocab_size=vocab))
    jstate = jax_init_state(jrun, jax.random.key(0))
    tstate = interop.train_state_from_jax(_np(jstate), device="cpu")
    jstep = jax.jit(jax_train_step(jrun, total_steps=15))
    tstep = make_train_step(trun, total_steps=15)
    src = SyntheticSource(trun, batch_override=2, seq_override=32)
    jl, tl = [], []
    for i in range(15):
        batch = src.batch_at(i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, _tb(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    for losses in (jl, tl):
        assert np.mean(losses[-5:]) > np.mean(losses[:5])


def test_train_state_interop_and_shapes():
    jrun, trun = _runs("svff-bench", optimizer=TOpt(name="adafactor"))
    jstate = _np(jax_init_state(jrun, jax.random.key(1)))
    tstate = interop.train_state_from_jax(jstate, device="cpu")
    back = interop.train_state_to_jax(tstate)
    for (path, a), (_, b) in zip(tree_items(jstate), tree_items(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    shapes = train_state_shapes(trun)
    assert {p: (tuple(t.shape), t.dtype) for p, t in tree_items(shapes)} \
        == {p: (tuple(t.shape), t.dtype) for p, t in tree_items(tstate)}
    assert all(t.device.type == "meta" for _, t in tree_items(shapes))


# ---------------------------------------------------------------------------
# the train Tenant under the SVFF manager
# ---------------------------------------------------------------------------
def _tenant_script(mgr, tn, paused_error):
    """The op sequence: run, pause (work refused, queries answered),
    unpause, run, reconf through pause, run, reconf through detach/attach
    (state through disk), run. Returns (losses, phase names, queries)."""
    losses, names = [], []

    def run(n):
        for _ in range(n):
            losses.append(tn.run_steps(1)["loss"])
    run(2)
    names.append(sorted(mgr.pause(tn).phases))
    with pytest.raises(paused_error):
        tn.run_steps(1)
    queries = [tn.query()]
    names.append(sorted(mgr.unpause(tn).phases))
    run(1)
    names.append(sorted(mgr.reconf(1, use_pause=True)))
    run(1)
    names.append(sorted(mgr.reconf(1, use_pause=False)))
    run(1)
    queries.append(tn.query())
    return losses, names, queries


def _journal(mgr):
    return [(e["op"], e["tenant"], e["vf_id"], e["status"])
            for e in mgr.journal.entries()]


def _records(mgr):
    out = {}
    for tid in mgr.records.list():
        rec = mgr.records.read(tid)
        rec.pop("written_at")
        out[tid] = rec
    return out


def test_tenant_under_manager_matches_jax(tmp_path):
    """The JAX Tenant on the one JAX CPU device and the port's on a pool
    slot named alike, from the same train state, through the same script:
    equal journals, records, VF tables and phase names, losses within the
    fp32 bound, and the port's losses bit-equal to an undisturbed port
    tenant's."""
    jrun, trun = _runs("svff-bench")
    jdev = jax.devices()[:1]
    jmgr = JManager(JPool(devices=jdev, max_vfs=4),
                    workdir=str(tmp_path / "jax"))
    jt = JTenant("vm0", jrun, local_batch=2, seq_len=16, seed=0)
    jmgr.init(num_vfs=1, tenants=[jt])
    start = _np(jt.export_state())

    def port_tenant(name):
        mgr = SVFFManager(DevicePool([str(d) for d in jdev], max_vfs=4),
                          workdir=str(tmp_path / name))
        tn = Tenant("vm0", trun, local_batch=2, seq_len=16, seed=0,
                    device="cpu")
        tn._state = interop.train_state_from_jax(start, device="cpu")
        mgr.init(num_vfs=1, tenants=[tn])
        return mgr, tn

    tmgr, tt = port_tenant("port")
    jl, jnames, jq = _tenant_script(jmgr, jt, JPaused)
    tl, tnames, tq = _tenant_script(tmgr, tt, DevicePausedError)
    assert tnames == jnames
    assert _journal(tmgr) == _journal(jmgr)
    assert all(e[3] == "committed" for e in _journal(tmgr))
    assert _records(tmgr) == _records(jmgr)
    assert ([vf.describe() for vf in tmgr.pool.vfs.values()]
            == [vf.describe() for vf in jmgr.pool.vfs.values()])
    # the JAX tenant keys its executables by device id, the port's by slot
    names = {str(d.id): str(d) for d in jdev}
    for q_port, q_jax in zip(tq, jq):
        keys = [[k[0], k[1], str(tuple(names[i] for i in k[2].strip(
            "(),").split(", ")))] for k in q_jax.pop("exec_keys")]
        assert q_port.pop("exec_keys") == keys
        assert q_port == q_jax
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    # transparency: the pauses and the trip through disk change no bit
    _, still = port_tenant("still")
    assert [still.run_steps(1)["loss"] for _ in tl] == tl


def test_pause_frees_every_tensor_of_the_train_state(tmp_path):
    """A paused train tenant holds no tensor of its state, with the
    garbage collector off (no reference cycle may hold them); the
    snapshot is host-only; the unpause brings the state back."""
    import gc
    import weakref
    _, trun = _runs("svff-bench")
    mgr = SVFFManager(DevicePool(["slot0", "slot1"], max_vfs=2),
                      workdir=str(tmp_path))
    tn = Tenant("vm0", trun, local_batch=2, seq_len=16, device="cpu")
    mgr.init(num_vfs=1, tenants=[tn])
    tn.run_steps(1)
    refs = [weakref.ref(t) for _, t in tree_items(tn.export_state())]
    gc.disable()
    try:
        mgr.pause(tn)
        assert not any(r() is not None for r in refs)
    finally:
        gc.enable()
    assert tn.export_state() is None and tn.status == "paused"
    assert mgr.staging.memo_size("vm0") == 0
    with pytest.raises(DevicePausedError):
        tn.run_steps(1)
    mgr.unpause(tn)
    assert tn.run_steps(1)["loss"] > 0


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_paused_train_tenant_snapshot_specs_equal_jax(tmp_path, opt):
    """The config-space snapshot of a train tenant paused on a 2-device
    and on an 8-device VF of an 8-slot pool carries the JAX tenant's
    ``sharding_desc`` for that VF's mesh, entry for entry, order
    included (the port's tenant exported ``{}`` before)."""
    from repro.configs import MeshConfig as JMesh
    from repro.core.snapshot import serialize_specs as jax_serialize
    from repro.runtime.partitioning import ShardingRules as JRules
    from repro.train.step import train_state_specs as jax_state_specs
    jrun, trun = _runs("qwen3-0.6b", optimizer=TOpt(name=opt))
    mgr = SVFFManager(DevicePool([f"slot{i}" for i in range(8)], max_vfs=8),
                      workdir=str(tmp_path))
    tn = Tenant("vm0", trun, local_batch=2, seq_len=16, device="cpu")
    mgr.init(num_vfs=4, tenants=[tn], devices_per_vf=2)
    seen = []
    for devices in (2, 8):
        if devices == 8:
            mgr.pool.set_num_vfs(1, devices_per_vf=8)
            mgr.unpause(tn, num_devices=8)
        mgr.pause(tn)
        snap = mgr.snapshots["vm0"]
        seen.append(tuple(snap.mesh_shape))
        want = jax_serialize(jax_state_specs(jrun, JRules(
            JMesh(tuple(snap.mesh_shape), tuple(snap.mesh_axes)), jrun)))
        assert len(want) > 3
        assert [tuple(e) for e in snap.sharding_desc] == \
            [tuple(e) for e in want]
    assert seen == [(2, 1), (4, 2)]


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------
def _run_py(argv, timeout=600):
    # one intra-op thread: beside the suite's other workers, torch's
    # thread pool would spin against them (the smoke model needs no more)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable] + argv, capture_output=True,
                          text=True, env=env, timeout=timeout)


@pytest.mark.slow
def test_launch_train_learns(tmp_path):
    out = _run_py(["-m", "repro_torch.launch.train", "--device", "cpu",
                   "--arch", "qwen3-0.6b", "--smoke", "--steps", "30",
                   "--batch", "8", "--seq", "64", "--lr", "3e-3",
                   "--warmup", "5", "--workdir", str(tmp_path),
                   "--checkpoint-every", "10"])
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in
             open(tmp_path / "metrics.jsonl").read().splitlines()]
    assert lines[-1]["step"] == 30
    assert lines[-1]["loss"] < lines[0]["loss"] - 0.3, (
        lines[0]["loss"], lines[-1]["loss"])
    assert {"loss", "ce", "ntok", "grad_norm", "lr", "step", "step_s",
            "tokens_per_s"} <= set(lines[0])
    assert any(d.startswith("step_") for d in os.listdir(tmp_path / "ckpt"))


@pytest.mark.slow
def test_train_crash_restart_bit_identical(tmp_path):
    """Kill the run mid-way; --resume must end at the uninterrupted
    run's loss (determinism + crash consistency)."""
    common = ["-m", "repro_torch.launch.train", "--device", "cpu",
              "--arch", "qwen3-0.6b", "--smoke", "--steps", "20",
              "--batch", "4", "--seq", "32", "--lr", "1e-2", "--warmup",
              "2", "--checkpoint-every", "5"]
    ref = _run_py(common + ["--workdir", str(tmp_path / "a")])
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref_last = json.loads(ref.stdout.strip().splitlines()[-1])
    crash = _run_py(common + ["--workdir", str(tmp_path / "b"),
                              "--crash-at", "10"])
    assert crash.returncode == 17          # simulated hard crash
    resume = _run_py(common + ["--workdir", str(tmp_path / "b"),
                               "--resume"])
    assert resume.returncode == 0, resume.stderr[-2000:]
    assert "resumed from step 10" in resume.stdout
    res_last = json.loads(resume.stdout.strip().splitlines()[-1])
    assert res_last["loss"] == ref_last["loss"]


# ---------------------------------------------------------------------------
# Tables I and II
# ---------------------------------------------------------------------------
def test_tables_give_the_jax_rows(capsys):
    from repro_torch.bench import table1, table2
    assert table1.main(["--device", "cpu", "--runs", "2", "--vfs", "1",
                        "4"]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["num_vf"] for r in rows] == [1, 4]
    keys = {"num_vf", "runs", "compression", "detach_attach_ms",
            "detach_attach_std", "pause_unpause_ms", "pause_unpause_std",
            "overhead_pct", "ms_per_vf_delta"}
    assert all(set(r) == keys and r["runs"] == 2 for r in rows)
    assert table2.main(["--device", "cpu", "--vfs", "1", "4"]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    keys = {"num_vf"} | {f"{m}_{s}_ms" for m in ("DA", "PU")
                         for s in table2.STEPS}
    assert [r["num_vf"] for r in rows] == [1, 4]
    assert all(set(r) == keys for r in rows)
    assert all(r["PU_total_ms"] > 0 and r["DA_total_ms"] > 0 for r in rows)


def test_unported_data_families_raise():
    """The vision and encoder-decoder inputs are ported: a vision model's
    batch carries the JAX pipeline's patches and an encoder-decoder's its
    frames, bit for bit, where the port raised before."""
    for arch in ("internvl2-1b", "seamless-m4t-medium"):
        jrun = jax_run_config(arch, "train_4k", smoke=True)
        trun = torch_run_config(arch, "train_4k", smoke=True)
        want = JSource(jrun, batch_override=2, seq_override=16).batch_at(1)
        got = SyntheticSource(trun, batch_override=2,
                              seq_override=16).batch_at(1)
        assert got.keys() == want.keys() and len(got) == 3
        for k in want:
            assert np.array_equal(got[k], want[k]), (arch, k)
    batch = to_device(SyntheticSource(trun, batch_override=2,
                                      seq_override=8).batch_at(0), "cpu")
    assert batch["tokens"].dtype == torch.int32
    assert tuple(batch["labels"].shape) == (2, 8)
