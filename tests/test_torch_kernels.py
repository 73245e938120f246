"""The port's kernel modules against the JAX package: each plain PyTorch
version against JAX's oracle (``repro.kernels.ref``) and JAX's Pallas
kernel in interpret mode, on the same numpy inputs made from a seed.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.

Tolerances: fp32 inputs agree to 2e-5 (the frameworks sum in other
orders); bf16 inputs to 2e-2, one bf16 step at the outputs' magnitude,
since both sides round their fp32 result to bf16 once. Sampling is
bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import sampling as jsampling
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_decode import paged_decode as pallas_paged
from repro.kernels.paged_decode import \
    paged_decode_quant as pallas_paged_quant
from repro_torch.kernels import ops, sampling
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    """One float32 numpy array as a JAX and a torch array of ``dtype``
    (both round to nearest even, so the bits agree)."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a.copy()).to(TDT[dtype]))


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.to(torch.float32).numpy(),
                               np.asarray(want_j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,causal", [
    (1, 8, 4, 2, 32, True),          # GQA, one short tile
    (2, 64, 4, 4, 32, True),         # MHA
    (1, 128, 4, 1, 64, False),       # MQA, bidirectional
    (1, 256, 4, 2, 32, True),        # two 128-row tiles in Pallas
])
def test_flash_attention_plain_matches_jax(B, S, H, K, hd, causal, dtype):
    rng = np.random.default_rng(S + H)
    qn, kn, vn = (rng.standard_normal((B, S, n, hd), np.float32)
                  for n in (H, K, K))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=causal),
           TOL[dtype])
    _close(got, pallas_flash(qj, kj, vj, causal=causal, interpret=True),
           TOL[dtype])
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, hd)


def test_flash_attention_any_length_plain():
    """The plain version (like the CUDA kernel) takes a prompt length the
    Pallas wrapper rejects (S % min(128, S) != 0): checked against JAX's
    oracle, whose bottom-right causal mask equals top-left for S == T."""
    rng = np.random.default_rng(7)
    S = 200
    qn = rng.standard_normal((1, S, 4, 32), np.float32)
    kn, vn = (rng.standard_normal((1, S, 2, 32), np.float32) for _ in "kv")
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (qn, kn, vn)))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)))
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_model_attention_matches_jax(causal):
    """The model-level entry points: the port's ``attention`` (which
    dispatches to the flash kernel's plain version on the CPU) against
    JAX's at ``backend="pallas"`` in interpret mode, and both
    ``attention_ref``s (bf16 probabilities into PV) against each other.
    A query offset or a KV length is refused, not run on plain torch."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(11)
    qn, kn, vn = (rng.standard_normal((2, 16, n, 32), np.float32)
                  for n in (4, 2, 2))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, "bfloat16")
                                    for a in (qn, kn, vn))
    _close(tattn.attention(qt, kt, vt, causal=causal),
           jattn.attention(qj, kj, vj, causal=causal, backend="pallas",
                           interpret=True), TOL["bfloat16"])
    _close(tattn.attention_ref(qt, kt, vt, causal=causal),
           jattn.attention_ref(qj, kj, vj, causal=causal), TOL["bfloat16"])
    for kw in ({"q_offset": 3}, {"kv_len": 8}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tattn.attention(qt, kt, vt, causal=causal, **kw)


# ---------------------------------------------------------------------------
# paged_decode / paged_decode_quant
# ---------------------------------------------------------------------------
def _paged_inputs(seed, B=4, H=4, K=2, hd=32, page=8, NP=4, P=11,
                  positions=(5, -1, 31, 8)):
    """Random tables (page ids may repeat across slots), pos with an
    inactive slot (-1), a mid-page end (5), a full view (31) and a page
    boundary (8)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd), np.float32)
    kp = rng.standard_normal((P, page, K, hd), np.float32)
    vp = rng.standard_normal((P, page, K, hd), np.float32)
    tables = rng.integers(1, P, (B, NP)).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_matches_jax(dtype):
    q, kp, vp, tables, pos = _paged_inputs(1)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, kp, vp))
    tj, pj = jnp.asarray(tables), jnp.asarray(pos)
    tt, pt = torch.from_numpy(tables), torch.from_numpy(pos)
    got = ops.paged_decode(qt, kt, vt, tt, pt)
    _close(got, jref.paged_decode_ref(qj, kj, vj, tj, pj), TOL[dtype])
    _close(got, pallas_paged(qj, kj, vj, tj, pj, interpret=True), TOL[dtype])
    assert torch.all(got[1] == 0)          # pos = -1: an exactly-zero row


def test_kv_quant_bit_identical_to_jax():
    x = np.random.default_rng(2).standard_normal((5, 8, 2, 32), np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: the 1e-12 floor
    qj, sj = jref.kv_quant_ref(jnp.asarray(x))
    qt, st = tref.kv_quant_ref(torch.from_numpy(x))
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tref.kv_dequant_ref(qt, st).numpy(),
        np.asarray(jref.kv_dequant_ref(qj, sj)))


def test_paged_decode_quant_plain_matches_jax():
    q, kp, vp, tables, pos = _paged_inputs(3)
    qj, qt = _both(q, "bfloat16")
    kq, ks = jref.kv_quant_ref(jnp.asarray(kp))
    vq, vs = jref.kv_quant_ref(jnp.asarray(vp))
    tj, pj = jnp.asarray(tables), jnp.asarray(pos)
    got = ops.paged_decode_quant(
        qt, *(torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs)),
        torch.from_numpy(tables), torch.from_numpy(pos))
    tol = TOL["bfloat16"]
    _close(got, jref.paged_decode_quant_ref(qj, kq, vq, ks, vs, tj, pj), tol)
    _close(got, pallas_paged_quant(qj, kq, vq, ks, vs, tj, pj,
                                   interpret=True), tol)
    assert torch.all(got[1] == 0)


# ---------------------------------------------------------------------------
# fused_sample: bit-exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,rid,counter,n", [
    (0, 0, 0, 64), (7, 123, 5, 1000), (2**31 - 1, 2**31 - 1, 2**20, 300),
    (-1, -5, -9, 17)])
def test_gumbel_noise_bit_identical(seed, rid, counter, n):
    """The port's numpy copy and torch twin draw JAX's host noise exactly
    (negative keys wrap as int32 -> uint32, as in the engine)."""
    want = jsampling.host_gumbel(seed, rid, counter, n)
    assert np.array_equal(sampling.host_gumbel(seed, rid, counter, n), want)
    keys = torch.tensor([[seed, rid, counter]], dtype=torch.int64)
    keys = ((keys + 2**31) % 2**32 - 2**31).to(torch.int32)
    got = sampling.torch_gumbel(keys, torch.arange(n)).numpy()[0]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def engine():
    """A CPU engine of the smoke config: its ``_sample`` is the host
    oracle (vocab 512)."""
    from repro_torch.configs import make_run_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    run = make_run_config("qwen3-0.6b", "decode_32k", smoke=True)
    params = build_model(run).init(seed=0, device="cpu")
    return ServeEngine(run, params, device="cpu", slots=1, max_len=48,
                       paged=True)


@pytest.mark.parametrize("temp,top_k", [(0.0, 0), (1e-6, 0), (0.7, 1),
                                        (0.8, 50), (1.3, 0), (2.5, 512)])
def test_fused_sample_plain_bit_identical(engine, temp, top_k):
    """Greedy, temperature, top-k and the padded vocab tail: the plain
    version equals JAX's oracle, JAX's Pallas kernel (interpret) and the
    host ``_sample`` oracle token for token."""
    from repro_torch.serve.engine import Request
    V, B = engine.run.model.vocab_size, 6
    Vp = V + 8                                 # padded tail columns
    rng = np.random.default_rng(int(temp * 10) + top_k)
    logits = rng.standard_normal((B, Vp)).astype(np.float32)
    logits[:, V:] = 50.0                       # the tail must never win
    logits[3, 10] = logits[3, 20] = 9.0        # a tie: first index wins
    keys = np.asarray([[7 + i, 100 + i, 3 * i] for i in range(B)], np.int32)
    temp_a = np.full((B,), temp, np.float32)
    topk_a = np.full((B,), top_k, np.int32)
    got = ops.fused_sample(torch.from_numpy(logits),
                           torch.from_numpy(temp_a),
                           torch.from_numpy(topk_a),
                           torch.from_numpy(keys), vocab_size=V).tolist()
    jargs = (jnp.asarray(logits), jnp.asarray(temp_a), jnp.asarray(topk_a),
             jnp.asarray(keys))
    assert got == [int(t) for t in jref.fused_sample_ref(*jargs,
                                                         vocab_size=V)]
    assert got == [int(t) for t in jsampling.fused_sample(
        *jargs, vocab_size=V, interpret=True)]
    reqs = [Request(rid=int(r), prompt=[1], temperature=temp, top_k=top_k,
                    seed=int(sd)) for sd, r, _ in keys]
    for req, (_, _, ctr) in zip(reqs, keys):
        req.out = [0] * int(ctr)               # the token counter
    assert got == [engine._sample(req, logits[b])
                   for b, req in enumerate(reqs)]
    assert all(t < V for t in got)


def test_ops_dispatch_rules():
    """CPU tensors take the plain version and count no launch; an unknown
    backend is refused."""
    q = torch.zeros((1, 4, 2, 32))
    ops.reset_launch_counts()
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1], backend="ref")
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHES, 0)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, backend="pallas")


def test_kernel_build_cache_keys():
    """Each source has its own library, named by the hash of its source,
    the shared header and its flags (sampling: no FMA contraction)."""
    from repro_torch.kernels import build
    paths = {n: build.library_path(n) for n in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").exists()
    assert "--fmad=false" in build.KERNELS["fused_sample"][0]
