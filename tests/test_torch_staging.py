"""The port's staging kernels and StagingEngine against the JAX package's.

Kernels: the plain versions of ``qdma_pack``, ``qdma_pack_rows``,
``qdma_unpack`` and ``qdma_digest`` (what a CPU tensor runs, and what the
CUDA kernels are held against on the card) equal the Pallas kernels in
interpret mode bit for bit. Engine: the same nested tree, saved and
restored by both packages' ``StagingEngine``s, gives bit-equal host
payloads, restored values and ``TransferStats`` counts, for both engines
(pipelined and ``pipeline=False``), both transports, both dirty modes,
with and without int8 compression. Inputs are numpy arrays from a seed.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro.core import staging as jstaging
from repro.kernels import qdma_pack as jqp
from repro_torch import interop
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import staging as tstaging
from repro_torch.kernels import ops
from repro_torch.tree import flatten

BF16 = ml_dtypes.bfloat16


def _scaled(rng, shape, dtype):
    """Rows of very different magnitudes (one scale per block), plus an
    all-zero block (the 1e-12 scale floor)."""
    x = rng.standard_normal(shape) * np.exp(
        4 * rng.standard_normal(shape[:-1] + (1,)))
    x.reshape(-1, shape[-1])[0, :128] = 0
    return x.astype(dtype)


def _bits(x):
    """Raw bytes of a host leaf of either package, for bit comparisons."""
    if isinstance(x, torch.Tensor):
        x = interop._to_numpy(x)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _same(a, b):
    a = interop._to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    b = interop._to_numpy(b) if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype,
                                                       b.shape, b.dtype)
    assert np.array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("M", [1, 9, 300])
def test_pack_unpack_plain_match_jax_interpret(dtype, block, M):
    x = _scaled(np.random.default_rng(M + block), (M, 512), dtype)
    q, s = jqp.qdma_pack(jnp.asarray(x), block=block, interpret=True)
    tq, ts = ops.qdma_pack(interop._to_torch(x, "cpu"), block=block)
    _same(tq, q)
    _same(ts, s)
    name = "float32" if dtype is np.float32 else "bfloat16"
    u = jqp.qdma_unpack(q, s, dtype=name, interpret=True)
    _same(ops.qdma_unpack(tq, ts, dtype=name), u)


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("block", [128, 256])
def test_pack_rows_plain_matches_jax_interpret(dtype, block):
    x = _scaled(np.random.default_rng(block), (4, 75, 256), dtype)
    for lo, rows in ((0, 300), (37, 100), (299, 1)):
        q, s = jqp.qdma_pack_rows(jnp.asarray(x), lo, rows=rows,
                                  block=block, interpret=True)
        tq, ts = ops.qdma_pack_rows(interop._to_torch(x, "cpu"), lo,
                                    rows=rows, block=block)
        _same(tq, q)
        _same(ts, s)


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only numpy and the
    standard library at the top): its staging test leaves."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("block", [128, 256])
def test_pack_unpack_nan_inf_blocks_match_jax_interpret(dtype, block):
    """A NaN in a block makes its scale NaN, an inf makes it inf, and the
    block packs to q 0 throughout (x / NaN and inf / inf are NaN, which
    converts to 0); the unpack gives NaN across such a block, in bfloat16
    XLA's NaN (0x7FC0 with the sign). Plain version and Pallas kernel
    agree bit for bit, scales, q and unpacked values alike."""
    x = CS.qdma_special(block).astype(dtype)
    q, s = jqp.qdma_pack(jnp.asarray(x), block=block, interpret=True)
    tq, ts = ops.qdma_pack(interop._to_torch(x, "cpu"), block=block)
    _same(tq, q)
    _same(ts, s)
    rq, rs = ops.qdma_pack_rows(interop._to_torch(x, "cpu"), 1, rows=1,
                                block=block)
    _same(rq, np.asarray(q)[1:])
    _same(rs, np.asarray(s)[1:])
    s = np.asarray(s).reshape(-1)
    assert np.isnan(s[[0, 3]]).all() and (s[[1, 2]] == np.inf).all()
    assert s[4] == np.float32(1e-12)
    assert not np.asarray(q).reshape(6, block)[:4].any()
    for name in ("float32", "bfloat16"):
        u = jqp.qdma_unpack(q, jnp.asarray(s.reshape(2, 3)), dtype=name,
                            interpret=True)
        tu = ops.qdma_unpack(tq, ts, dtype=name)
        _same(tu, u)
        assert np.isnan(np.asarray(u, np.float32).reshape(6, block)[:4]).all()


@pytest.mark.parametrize("dtype", [np.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("block", [128, 256])
def test_pack_ties_and_edges_match_jax_interpret(dtype, block):
    """Quotients x / scale at n + 0.5 (exact ties, which round to even),
    a few ulp either side, and at the +-127 edges, with scales from the
    1e-12 floor (subnormal x among them) to 2**113: plain pack, pack_rows
    and unpack equal the Pallas kernels bit for bit."""
    x = CS.qdma_ties(block).astype(dtype)
    if dtype is np.float32:
        s = np.maximum(np.abs(x).max(-1, keepdims=True)
                       * (np.float32(1) / np.float32(127)), np.float32(1e-12))
        c = x / s
        assert (c - np.floor(c) == 0.5).sum() > 1000
        assert (np.abs(c) == 127).sum() >= x.shape[0]
    q, s = jqp.qdma_pack(jnp.asarray(x), block=block, interpret=True)
    tq, ts = ops.qdma_pack(interop._to_torch(x, "cpu"), block=block)
    _same(tq, q)
    _same(ts, s)
    rq, rs = ops.qdma_pack_rows(interop._to_torch(x, "cpu"), 5, rows=300,
                                block=block)
    _same(rq, np.asarray(q)[5:305])
    _same(rs, np.asarray(s)[5:305])
    for name in ("float32", "bfloat16"):
        _same(ops.qdma_unpack(tq, ts, dtype=name),
              jqp.qdma_unpack(q, s, dtype=name, interpret=True))


@pytest.mark.parametrize("kind", ["bool", "int8", "int32", "bf16", "fp32",
                                  "scalar"])
def test_digest_plain_matches_jax_interpret(kind):
    """Sizes that are not multiples of the Pallas kernel's 64 KiB tile:
    its zero padding is digest-neutral, and the plain version pads
    nothing."""
    rng = np.random.default_rng(7)
    x = {"bool": lambda: rng.random(70_001) < 0.3,
         "int8": lambda: rng.integers(-128, 128, 131_075).astype(np.int8),
         "int32": lambda: rng.integers(-2**31, 2**31 - 1,
                                       (33, 1001)).astype(np.int32),
         "bf16": lambda: rng.standard_normal((5, 777)).astype(BF16),
         "fp32": lambda: rng.standard_normal((3, 70_000)).astype(np.float32),
         "scalar": lambda: np.float32(3.5)}[kind]()
    want = np.asarray(jqp.qdma_digest(jnp.asarray(x), interpret=True))
    t = (torch.from_numpy(np.asarray(x)) if x.dtype == bool
         else interop._to_torch(x, "cpu"))
    got = ops.qdma_digest(t)
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()


# ---------------------------------------------------------------------------
# the engine, both packages on the same tree
# ---------------------------------------------------------------------------
def _tree_np(seed=0):
    """A nested state tree: packable fp32 and bf16 leaves (big enough to
    row-chunk at a 16 KiB chunk size), an fp32 leaf whose last dim the
    block does not divide, int8/int32 device leaves, host numpy leaves
    and a scalar."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": _scaled(rng, (24, 512), np.float32),
                   "e": rng.standard_normal((40, 100)).astype(np.float32),
                   "kv": _scaled(rng, (6, 4, 256), BF16)},
        "cache": {"q8": rng.integers(-127, 128, (8, 300)).astype(np.int8),
                  "ids": rng.integers(0, 9, (33,)).astype(np.int32)},
        # int32: JAX without x64 would restore an int64 leaf as int32
        "pos": rng.integers(0, 50, (4,)).astype(np.int32),
        "step": np.float32(2.0),
    }


_HOST_KEYS = ("pos",)          # numpy on the host in both packages


def _jax_tree(t):
    return {k: (v if k in _HOST_KEYS else
                jax.tree.map(jnp.asarray, v)) for k, v in t.items()}


def _torch_tree(t):
    return {k: (v if k in _HOST_KEYS else
                jax.tree.map(lambda a: interop._to_torch(a, "cpu"), v))
            for k, v in t.items()}


def _payload_leaves_equal(jp, tp):
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jp, is_leaf=lambda x: isinstance(x, jstaging._Opaque))
    tflat, _ = flatten(tp, is_leaf=lambda x: isinstance(x, tstaging._Opaque))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        if isinstance(a, jstaging._Opaque):
            assert isinstance(b, tstaging._Opaque)
            _same(b.leaf.q, a.leaf.q)
            _same(b.leaf.scale, a.leaf.scale)
            assert (b.leaf.dtype, b.leaf.block) == (a.leaf.dtype,
                                                    a.leaf.block)
        else:
            _same(b, a)


def _stats(s):
    return (s.bytes_moved, s.logical_bytes, s.skipped_bytes,
            s.num_descriptors, s.num_leaves)


ENGINES = {
    "borrow": dict(transport="borrow"),
    "stream": dict(transport="stream"),
    "legacy": dict(pipeline=False),
}


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_save_restore_parity(compression, engine):
    kw = dict(ENGINES[engine], compression=compression, block=128,
              chunk_bytes=16 << 10, min_quant_size=1024)
    je, te = jstaging.StagingEngine(**kw), tstaging.StagingEngine(**kw)
    t = _tree_np()
    jpay = je.save(_jax_tree(t))
    tpay = te.save(_torch_tree(t))
    _payload_leaves_equal(jpay, tpay)
    assert _stats(te.last_stats) == _stats(je.last_stats)
    assert te.last_stats.num_descriptors > 1 or engine == "legacy"
    jrest = je.restore(jpay)
    trest = te.restore(tpay, "cpu")
    assert _stats(te.last_stats)[:2] == _stats(je.last_stats)[:2]
    assert te.last_stats.num_descriptors == je.last_stats.num_descriptors
    jflat = jax.tree_util.tree_leaves(jrest)
    tflat = [x for _, x in flatten(trest)[0]]
    for a, b in zip(jflat, tflat):
        _same(b, np.asarray(a))
    # the restored state is a copy: writing it leaves the snapshot as is
    before = _bits(tpay["params"]["e"]).copy()
    trest["params"]["e"].add_(1.0)
    assert np.array_equal(_bits(tpay["params"]["e"]), before)


def test_snapshot_never_aliases_live_cpu_state():
    """``borrow`` on the CPU copies: a later in-place write to the live
    tensor does not reach the snapshot."""
    x = torch.arange(64, dtype=torch.float32)
    te = tstaging.StagingEngine(transport="borrow")
    snap = te.save({"x": x})
    x.mul_(2)
    assert torch.equal(snap["x"], torch.arange(64, dtype=torch.float32))


@pytest.mark.parametrize("engine", ["borrow", "legacy"])
def test_digest_dirty_tracking_skips_equal_leaves(engine):
    """Round 2 hands in new arrays: one leaf with the same bytes (skipped
    by digest), one changed (moved), the rest the same objects (skipped
    by identity). Both packages skip the same bytes."""
    kw = dict(ENGINES[engine], incremental=True, dirty="digest")
    je, te = jstaging.StagingEngine(**kw), tstaging.StagingEngine(**kw)
    t = _tree_np(1)
    jt, tt = _jax_tree(t), _torch_tree(t)
    je.save(jt, tenant="a")
    te.save(tt, tenant="a")
    changed = t["cache"]["ids"] + 1
    jt["params"]["e"] = jnp.asarray(t["params"]["e"].copy())
    tt["params"]["e"] = interop._to_torch(t["params"]["e"].copy(), "cpu")
    jt["cache"]["ids"] = jnp.asarray(changed)
    tt["cache"]["ids"] = interop._to_torch(changed, "cpu")
    jpay = je.save(jt, tenant="a")
    tpay = te.save(tt, tenant="a")
    _payload_leaves_equal(jpay, tpay)
    assert _stats(te.last_stats) == _stats(je.last_stats)
    total = sum(tstaging._nbytes(x) for _, x in flatten(tt)[0])
    assert te.last_stats.skipped_bytes == total - changed.nbytes
    assert te.memo_size("a") == je.memo_size("a")
    te.clear("a")
    assert te.memo_size() == 0


def test_identity_memo_defeated_by_in_place_write():
    """JAX arrays are immutable, so the JAX engine's identity memo trusts
    the same object; a torch tensor written in place is the same object
    with other bytes. The port's memo checks ``_version`` too."""
    te = tstaging.StagingEngine(incremental=True, dirty="identity")
    a, b = torch.zeros(1000), torch.ones(1000)
    te.save({"a": a, "b": b}, tenant="t")
    a.add_(5)                                      # in place: same object
    snap = te.save({"a": a, "b": b}, tenant="t")
    assert te.last_stats.skipped_bytes == b.numel() * 4     # b only
    assert torch.equal(snap["a"], torch.full((1000,), 5.0))
    te.save({"a": a, "b": b}, tenant="t")                  # now unchanged
    assert te.last_stats.skipped_bytes == 8000


def test_crash_mid_save_leaves_memo_unpublished():
    from repro_torch.core.fault import InjectedCrash, crash_plane
    te = tstaging.StagingEngine(incremental=True, transport="stream",
                                chunk_bytes=1 << 10)
    crash_plane.arm("mid_pipeline_chunk")
    with pytest.raises(InjectedCrash):
        te.save({"x": torch.ones(4096)}, tenant="t")
    assert te.memo_size("t") == 0


def test_jax_payload_restores_through_the_port():
    """A payload saved by the JAX engine (int8-packed leaves included)
    carries over with ``staged_from_jax`` and restores through the port's
    engine to the JAX restore's values; ``staged_to_jax`` carries it
    back bit for bit."""
    kw = dict(compression="int8", block=128, min_quant_size=1024)
    je, te = jstaging.StagingEngine(**kw), tstaging.StagingEngine(**kw)
    jpay = je.save(_jax_tree(_tree_np(2)))
    want = jax.tree_util.tree_leaves(je.restore(jpay))
    tpay = interop.staged_from_jax(jpay)
    got = [x for _, x in flatten(te.restore(tpay, "cpu"))[0]]
    assert len(got) == len(want)
    for a, b in zip(want, got):
        _same(b, np.asarray(a))
    back = interop.staged_to_jax(tpay, jstaging._Opaque,
                                 jstaging.QuantizedLeaf)
    _payload_leaves_equal(back, tpay)


def test_checkpoint_store_round_trip_and_crc_parity(tmp_path):
    """Raw-byte leaves with the dtype in the manifest: bf16 round-trips,
    numpy leaves come back numpy, and every leaf's crc32 equals the JAX
    store's for the same values."""
    t = _tree_np(3)
    tt = _torch_tree(t)
    store = CheckpointStore(str(tmp_path / "port"), keep=0)
    store.save(1, tt, metadata={"tenant_id": "a"})
    jstore = JStore(str(tmp_path / "jax"), keep=0)
    jstore.save(1, jax.tree.map(np.asarray, t))
    import json
    man = json.loads((tmp_path / "port" / "step_1" / "MANIFEST.json")
                     .read_text())
    jman = json.loads((tmp_path / "jax" / "step_1" / "MANIFEST.json")
                      .read_text())
    assert [m["crc32"] for m in man["leaves"]] == \
        [m["crc32"] for m in jman["leaves"]]
    assert [m["dtype"] for m in man["leaves"]] == \
        [m["dtype"] for m in jman["leaves"]]
    back = store.restore(1, tt)
    assert isinstance(back["pos"], np.ndarray)
    assert back["params"]["kv"].dtype == torch.bfloat16
    for (_, a), (_, b) in zip(flatten(tt)[0], flatten(back)[0]):
        _same(b, a)
    assert store.metadata(1) == {"tenant_id": "a"}
    assert store.steps() == [1] and store.sweep_tmp() == 0
