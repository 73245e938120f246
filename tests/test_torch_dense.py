"""The port's dense per-slot KV ring (``ServeEngine(paged=False)``, the
default layout, and ``Model.decode_step`` with a (B,) ``pos``) against
the JAX package's, on the CPU at smoke widths.

Params come from the JAX init, converted; inputs from numpy seeds. Both
sides compute in fp32, where the two frameworks' logits agree to ~1e-6
and sampled token streams must be identical (host and fused sampling,
greedy and temperature/top-k requests mixed).

Tolerance: 1e-4 absolute and relative on logits and cache leaves (values
of magnitude ~1; fp32 sums in other orders, amplified through the
layers — the tolerance of ``test_torch_model.py`` and
``test_torch_ssm.py``). The inactive slot's bytes are compared exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.core import ManagerError as JManagerError
from repro.models.model import build_model as jax_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.fleet import ServeFleet as JFleet
from repro.serve.paged import RequestRejected as JRejected
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.core.errors import ManagerError as TManagerError
from repro_torch.models.model import build_model as torch_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.fleet import ServeFleet
from repro_torch.serve.paged import RequestRejected
from repro_torch.tree import tree_items, tree_to

TOL = 1e-4
QWEN = "qwen3-0.6b"
HYBRID = "jamba-1.5-large-398b-1p-dense"


def _runs(arch):
    if arch == QWEN:
        jrun = jax_run_config(QWEN, "decode_32k", smoke=True,
                              precision=JPrecision(compute="float32"))
    else:
        jrun = jax_run_config("jamba-1.5-large-398b", "decode_32k",
                              smoke=True,
                              precision=JPrecision(compute="float32"))
        jrun = dataclasses.replace(
            jrun, model=dataclasses.replace(jrun.model, moe=None))
    trun = torch_run_config(arch, "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"))
    return jrun, trun


_SETUPS = {}


def _setup(arch):
    """(jrun, JAX params, trun, port params), built once per arch."""
    if arch not in _SETUPS:
        jrun, trun = _runs(arch)
        jp = jax_model(jrun).init(jax.random.key(0))
        tp = interop.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _SETUPS[arch] = (jrun, jp, trun, tp)
    return _SETUPS[arch]


def _close(got, want, msg=""):
    g = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(g, np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=msg)


# ---------------------------------------------------------------------------
# the model: decode_step with per-slot positions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [QWEN, HYBRID])
def test_per_slot_decode_matches_jax(arch):
    """Slots prefilled (B=1 each, as the engine does) to 5, 16 and 32
    tokens and written into a dense ring of 48 rows; three decode steps
    at per-slot positions with slot 1 inactive (pos -1). Active rows'
    logits and every cache leaf equal JAX's within TOL; slot 1's bytes
    in every leaf are exactly as before."""
    jrun, jp, trun, tp = _setup(arch)
    jm, tm = jax_model(jrun), torch_model(trun)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    params = tm.compute_params(tp)
    lens, T = (5, 16, 32), 48
    rng = np.random.default_rng(11)
    shape = dataclasses.replace(trun.shape, seq_len=T, global_batch=3)
    ring = tm.init_cache(shape, device="cpu")
    for b, L in enumerate(lens):
        toks = rng.integers(0, 500, (1, L))
        c, _ = jprefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
        for (blk, name), leaf in tree_items(c):
            leaf = torch.from_numpy(np.array(leaf, np.float32))
            if name in ("k", "v"):
                ring[blk][name][:, b, :L] = leaf[:, 0]
            else:
                ring[blk][name][:, b] = leaf[:, 0]
    # a copy: JAX may alias a numpy buffer, and its decode (dispatched
    # asynchronously) must not read the port's in-place writes
    jc = {blk: {n: jnp.asarray(t.numpy().copy()) for n, t in node.items()}
          for blk, node in ring.items()}
    before = {(blk, n): t[:, 1].clone() for blk, node in ring.items()
              for n, t in node.items()}
    k_leaf = ring["block0"]["k"]
    active = np.array([True, False, True])
    for step in range(3):
        pos = np.where(active, np.array(lens) + step, -1).astype(np.int32)
        toks = rng.integers(0, 500, (3, 1))
        jl, jc = jdecode(jp, jc, jnp.asarray(toks, jnp.int32),
                         jnp.asarray(pos), active=jnp.asarray(active))
        tl, ring = tm.decode_step(params, ring, torch.tensor(toks),
                                  torch.tensor(pos),
                                  active=torch.tensor(active))
        _close(tl[torch.tensor(active)], np.asarray(jl)[active],
               f"logits, step {step}")
    assert ring["block0"]["k"] is k_leaf                # written in place
    for (path, a), (_, b) in zip(tree_items(jc), tree_items(ring)):
        _close(b, a, str(path))
    for (blk, n), old in before.items():
        assert torch.equal(ring[blk][n][:, 1].view(torch.uint8),
                           old.view(torch.uint8)), (blk, n)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _requests(cls, n=5, new=8, hybrid=False):
    """Mixed greedy and sampled requests (temperature 0.8, top-k 0 or 16)
    of varied prompt lengths (the hybrid's obey its SSM chunk of 16)."""
    out = []
    for i in range(n):
        plen = (4, 16, 9, 32, 12)[i % 5] if hybrid else 5 + 3 * i
        out.append(cls(rid=i, prompt=(np.arange(plen) * (i + 2) + 1) % 500,
                       max_new_tokens=new,
                       temperature=0.8 if i % 2 else 0.0,
                       top_k=16 if i % 4 == 1 else 0, seed=3 + i))
    return out


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    res = engine.run_until_idle()
    assert res.drained and all(r.done and not r.error for r in reqs)
    return [list(r.out) for r in reqs]


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for rid, (g, w) in enumerate(zip(got, want)):
        if g != w:
            i = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                     min(len(g), len(w)))
            pytest.fail(f"request {rid} diverges at token {i}: "
                        f"port {g[i:i + 4]} vs JAX {w[i:i + 4]}")


def _engines(arch, **kw):
    jrun, jp, trun, tp = _setup(arch)
    common = dict(dict(slots=2, max_len=56), **kw)
    return (JEngine(jrun, jp, **common),
            ServeEngine(trun, tp, device="cpu", **common))


@pytest.mark.parametrize("arch,fused", [(QWEN, False), (QWEN, True),
                                        (HYBRID, True)])
def test_dense_engine_streams_identical_to_jax(arch, fused):
    """Five requests through two dense slots (so slots are recycled and
    decode runs with an inactive slot): the same tokens as the JAX dense
    engine, host or fused sampling."""
    jeng, teng = _engines(arch, fused_sampling=fused)
    assert not jeng.paged and not teng.paged
    hyb = arch == HYBRID
    want = _serve(jeng, _requests(JRequest, hybrid=hyb))
    got = _serve(teng, _requests(Request, hybrid=hyb))
    _assert_streams_equal(got, want)
    assert tuple(teng._cache["block0"]["k"].shape[1:3]) == (2, 56)  # ring
    assert teng.stats == jeng.stats


def test_dense_engine_fused_equals_host():
    """I10 on the dense ring: fused sampling gives the host's tokens."""
    _, _, trun, tp = _setup(QWEN)
    host = _serve(ServeEngine(trun, tp, device="cpu", slots=3, max_len=56),
                  _requests(Request, n=6))
    fused = _serve(ServeEngine(trun, tp, device="cpu", slots=3, max_len=56,
                               fused_sampling=True), _requests(Request, n=6))
    _assert_streams_equal(fused, host)


def test_dense_engine_with_prefill_chunk_matches_jax():
    """Chunked prefill (chunks of 4) into the dense ring: each job's
    staging cache lands in its slot's rows, same tokens as JAX."""
    jeng, teng = _engines(QWEN, prefill_chunk=4, fused_sampling=True)
    assert teng.prefill_chunk == 4
    want = _serve(jeng, _requests(JRequest))
    got = _serve(teng, _requests(Request))
    _assert_streams_equal(got, want)


def test_dense_pause_export_import_round_trip():
    """A pause mid-run: the state (no block tables) staged to host
    memory, the engine's cache dropped and restored; the tokens are those
    of an undisturbed run, and the snapshot is a copy."""
    _, _, trun, tp = _setup(QWEN)
    kw = dict(device="cpu", slots=2, max_len=56, fused_sampling=True)
    want = _serve(ServeEngine(trun, tp, **kw), _requests(Request))
    eng = ServeEngine(trun, tp, **kw)
    reqs = _requests(Request)
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    eng.pause()
    assert "tables" not in eng.dirty_keys()
    st = eng.export_state()
    assert set(st) == {"params", "cache", "pos", "last_token"}
    assert st["cache"]["block0"]["k"] is not eng._cache["block0"]["k"]
    host = dict(st, params=tree_to(st["params"], "cpu"),
                cache=tree_to(st["cache"], "cpu", copy=True))
    eng._cache = None
    eng.import_state(host)
    eng.unpause()
    res = eng.run_until_idle()
    assert res.drained
    _assert_streams_equal([list(r.out) for r in reqs], want)


def test_dense_kv_dtype_without_paged_raises():
    jrun, jp, trun, tp = _setup(QWEN)
    with pytest.raises(ValueError, match="paged"):
        JEngine(jrun, jp, kv_dtype="int8")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(trun, tp, device="cpu", kv_dtype="int8")
    # prefix sharing is a paged feature: off on a dense engine, as in JAX
    assert not ServeEngine(trun, tp, device="cpu",
                           share_prefix=True).share_prefix
    assert not JEngine(jrun, jp, share_prefix=True).share_prefix


def test_dense_admit_migrated_raises_request_rejected():
    """A dense engine is no migration target and has nothing to migrate
    (JAX's dense branches): peek is None, defragment moves nothing,
    admit_migrated rejects, owns_request sees only slots and queue."""
    jeng, teng = _engines(QWEN)
    payload = {"rid": 7, "chain_len": 1, "page_size": 16, "pos": 3,
               "last": 1, "req": None}
    for eng, exc in ((jeng, JRejected), (teng, RequestRejected)):
        with pytest.raises(exc, match="not a paged engine"):
            eng.admit_migrated(payload, None)
        assert eng.peek_migratable() is None
        assert eng.defragment() == {}
        assert not eng.owns_request(7)
        eng.abort_incoming(7)                           # a no-op


def test_dense_recover_after_crash_serves_again():
    """``reset_after_crash`` drops the ring; the engine rebuilds it and
    serves the same tokens as JAX's engine after the same reset."""
    jeng, teng = _engines(QWEN)
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        for r in _requests(cls, n=2):
            eng.submit(r)
        eng.step()
        eng.reset_after_crash()
        assert eng._cache is None and not eng.queue
    want = _serve(jeng, _requests(JRequest, n=3))
    got = _serve(teng, _requests(Request, n=3))
    _assert_streams_equal(got, want)


def test_dense_fleet_scale_in_of_a_busy_engine_raises(tmp_path):
    """A fleet of dense engines serves; a busy dense engine cannot ship
    its active slots, so its scale-in raises ``ManagerError`` in both
    packages (JAX's fleet, ``fleet.py:697-700``), and its telemetry
    counts no pages."""
    jrun, jp, trun, tp = _setup(QWEN)
    kw = dict(num_engines=2, num_devices=4, slots=2, max_len=56,
              paged=False)
    fleets = ((JFleet(jrun, jp, workdir=str(tmp_path / "j"), **kw),
               JRequest, JManagerError),
              (ServeFleet(trun, tp, device="cpu",
                          workdir=str(tmp_path / "t"), **kw),
               Request, TManagerError))
    for fleet, cls, exc in fleets:
        for r in _requests(cls, n=4):
            fleet.submit(r)
        fleet.step()
        snap = fleet.telemetry_snapshot()
        assert all(e.pages_in_use == 0 and e.pages_free == 0
                   for e in snap.engines)
        busy = next(t for t in fleet.tenants if fleet.tenants[t].load)
        with pytest.raises(exc, match="still busy"):
            fleet.scale_in(busy)
        assert fleet.drain().drained


def test_launch_serve_without_paged_serves_dense(capsys, monkeypatch):
    """``launch.serve`` without ``--paged`` serves through the dense
    ring, as the JAX launcher does; ``--paged`` turns the pages on."""
    from repro_torch.launch import serve
    made = []

    class Spy(ServeEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self.paged)
    monkeypatch.setattr(serve, "ServeEngine", Spy)
    for argv, paged in (([], False), (["--paged"], True)):
        rc = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                         "--new-tokens", "4"] + argv)
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and out["completed"] == 3
        assert out["generated_tokens"] == 12
        assert made[-1] is paged
