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
# the attention kernels' P V numerics, emulated on the CPU
# ---------------------------------------------------------------------------
#: chip_smoke.py's elementwise limit for the attention kernels:
#: |kernel - plain| <= ATTN_ATOL + ATTN_RTOL * |plain|
ATTN_ATOL, ATTN_RTOL = 1e-4, 2 ** -6


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _emulate_kernel(q, k, v, causal, p_form, tile):
    """The CUDA attention kernels' arithmetic in torch: fp32 scores of
    bf16 q and k scaled by 1/sqrt(hd), an online softmax over ``tile``
    keys at a time with fp32 max and sum, and P into P V as the kernel
    rounds it — ``p_form`` "bf16" (one bf16 P) or "pair" (P_hi + P_lo,
    two bf16 products) — against bf16 V with fp32 accumulation; the
    output acc / l in bf16. q (B,S,H,hd), k and v (B,T,K,hd)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    s = torch.einsum("bskgh,btkh->bkgst", q.float().reshape(B, S, K, H // K, hd),
                     k.float()) / np.sqrt(hd)
    if causal:
        s = s.masked_fill(~torch.ones(S, T, dtype=torch.bool).tril(),
                          float("-inf"))
    m = torch.full(s.shape[:-1], float("-inf"))
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(s.shape[:-1] + (hd,))
    for t0 in range(0, T, tile):
        st = s[..., t0:t0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        hi = _bf16(p)
        pp = hi if p_form == "bf16" else hi + _bf16(p - hi)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", pp, v[:, t0:t0 + tile].float())
        m = m_new
    o = acc / l.clamp(min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(torch.bfloat16)


def _share(got, want):
    """The largest share of the elementwise limit any element uses."""
    d = (got.float() - want.float()).abs()
    return float((d / (ATTN_ATOL + ATTN_RTOL * want.float().abs())).max())


@pytest.mark.parametrize("case", ["qwen_prefill", "hybrid_prefill",
                                  "generate_pos63", "generate_pos511"])
def test_attention_pv_numerics(case):
    """Why both attention kernels feed P V a bf16 pair P_hi + P_lo: a
    CPU emulation of their rounding of P at the main paths' shapes
    (numpy standard-normal inputs, seed 0, rounded to bf16), against
    the plain versions ``flash_attention_ref`` / ``flash_decode_ref``.
    The share of the limit ATTN_ATOL + ATTN_RTOL * |plain| that the
    worst element uses:

        shape                                     bf16 P   P_hi + P_lo
        qwen prefill q (1,384,16,128), causal      11.3      0.484
        hybrid prefill q (1,512,64,128), 8 KV      21.4      0.484
        generate q (4,1,64,128), T 1024, pos 63     6.01      0.422
        generate, pos 511                           3.37      0.444

    A bf16 P alone rounds each probability by up to 2**-9 of its value;
    an output near zero (a short causal row, or a weighted mean of
    random values) cannot absorb that within the 1e-4 floor. The pair
    holds P to about 2**-16 of its value, and lands where fp32 P does
    (the output's own bf16 rounding)."""
    rng = np.random.default_rng(0)
    if case.startswith("generate"):
        pos = int(case[len("generate_pos"):])
        qn = rng.standard_normal((4, 1, 64, 128), np.float32)
        kn, vn = (rng.standard_normal((4, 1024, 8, 128), np.float32)
                  for _ in "kv")
        q, k, v = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn))
        want = tref.flash_decode_ref(q, k, v, pos)
        # a warp's online step covers 16 cache rows
        args = (q, k[:, :pos + 1], v[:, :pos + 1], False)
        tile = 16
    else:
        S, H = (384, 16) if case == "qwen_prefill" else (512, 64)
        q, k, v = (torch.from_numpy(rng.standard_normal((1, S, n, 128),
                                                        np.float32))
                   .bfloat16() for n in (H, 8, 8))
        want = tref.flash_attention_ref(q, k, v, causal=True)
        args = (q, k, v, True)
        tile = 64                   # the kernel's KV tile
    pair = _share(_emulate_kernel(*args, "pair", tile), want)
    single = _share(_emulate_kernel(*args, "bf16", tile), want)
    print(f"{case}: bf16 P {single:.3g}, P_hi + P_lo {pair:.3g}")
    assert pair <= 1            # what the kernels use: inside the limit
    assert single > 1           # bf16 P alone would not be


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
