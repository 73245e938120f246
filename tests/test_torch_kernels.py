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
import importlib.util
import pathlib

import jax
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
    # a query offset or a KV length takes the plain attention, as in the
    # JAX dispatch (a 0-d tensor offset too, even one holding 0)
    for kw in ({"q_offset": 3}, {"kv_len": 8},
               {"q_offset": 2, "kv_len": 12}):
        jkw = dict(kw)
        tkw = dict(kw, q_offset=torch.tensor(kw.get("q_offset", 0)))
        want = jattn.attention(qj, kj, vj, causal=causal, backend="pallas",
                               interpret=True, **jkw)
        _close(tattn.attention(qt, kt, vt, causal=causal, **kw), want,
               TOL["bfloat16"])
        _close(tattn.attention(qt, kt, vt, causal=causal, **tkw), want,
               TOL["bfloat16"])


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
    """The oracle is what the JAX engine runs: its quantizer under
    ``jit`` (the decode step and the admission scatter), where the scale
    is max|x| times float32(1/127)."""
    from repro.serve.paged import kv_quantize
    x = np.random.default_rng(2).standard_normal((5, 8, 2, 32), np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: the 1e-12 floor
    qj, sj = jax.jit(kv_quantize)(jnp.asarray(x))
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


def _offset(shape, dtype, nbytes: int):
    """A contiguous zero tensor that starts ``nbytes`` past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    step = torch.empty((), dtype=dtype).element_size()
    base = torch.zeros(n + 32, dtype=dtype)
    lead = (-base.data_ptr() % 16 + nbytes) // step
    return base[lead:lead + n].view(shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("name", ["q", "k_pages", "v_pages"])
def test_paged_check_refuses_misaligned(name, dtype):
    """The paged kernels read the pages 16 bytes and q 4 bytes at a time:
    a contiguous tensor that starts off a 16-byte boundary is refused with
    ValueError before a launch (a misaligned read would fault on the card
    and leave the error on the CUDA context)."""
    B, NP, P, page, K, hd, H = 2, 4, 9, 16, 2, 64, 4
    shapes = {"q": ((B, 1, H, hd), torch.bfloat16),
              "k_pages": ((P, page, K, hd), dtype),
              "v_pages": ((P, page, K, hd), dtype)}
    tables = torch.zeros((B, NP), dtype=torch.int32)
    pos = torch.zeros((B,), dtype=torch.int32)
    args = {n: _offset(shape, dt, 0) for n, (shape, dt) in shapes.items()}
    assert ops._check_paged(*args.values(), tables, pos, dtype) == \
        (B, NP, page, K, hd, H // K)
    shape, dt = shapes[name]
    args[name] = _offset(shape, dt, 4)
    assert args[name].is_contiguous()
    with pytest.raises(ValueError, match=name):
        ops._check_paged(*args.values(), tables, pos, dtype)


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only numpy and the
    standard library at the top)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: chip_smoke.py's paged phase: the timed positions (full view, inactive,
#: mid-page, page edge, first token, ...) over the serve pool's B=8,
#: page 16, NP 64
PAGED_POS = _chip_smoke().PAGED_POS


def _emulate_paged(q, k, v, pos, p_form, ks=None, vs=None, split_rows=128):
    """The paged kernels' arithmetic in torch, on logical views k, v
    (B,T,K,hd) (bf16 values, or int8 values with fp32 scales ks, vs
    (B,T,K)): per split of ``split_rows`` rows, four warps, each with an
    online softmax over its 16 rows of each 64-row tile in turn (fp32
    scores of bf16 q and k, times ks[r] for int8, times log2(e)/sqrt(hd),
    2^x); P into P V as one bf16 or the pair P_hi + P_lo, after the v
    scale is folded in (int8); the warps merge into the block's state,
    the splits in order into the output acc / max(l, 1e-30) in bf16."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    c = float(np.float32(1.4426950408889634 / np.sqrt(hd)))
    qg = q.float().reshape(B, K, G, hd)
    out = torch.zeros(B, K, G, hd)

    def merge(states):
        live = [st for st in states if st is not None]
        if not live:
            return None
        M = torch.stack([m for m, _, _ in live]).amax(0)
        L, A = torch.zeros_like(M), torch.zeros(M.shape + (hd,))
        for m, l, a in live:
            e = torch.exp2(m - M)
            L, A = L + e * l, A + e[..., None] * a
        return M, L, A

    for b in range(B):
        n = max(0, min(int(pos[b]) + 1, k.shape[1]))
        splits = []
        for r_begin in range(0, n, split_rows):
            r_end = min(r_begin + split_rows, n)
            warps = []
            for w in range(4):
                m = torch.full((K, G), float("-inf"))
                l, acc = torch.zeros(K, G), torch.zeros(K, G, hd)
                ran = False
                for r0 in range(r_begin + 16 * w, r_end, 64):
                    ran = True
                    rows = slice(r0, min(r0 + 16, r_end))
                    sc = torch.einsum("kgh,tkh->kgt", qg[b],
                                      k[b, rows].float())
                    if ks is None:
                        sc = sc * c
                    else:
                        sc = sc * (ks[b, rows].T[:, None, :] * c)
                    m_new = torch.maximum(m, sc.amax(-1))
                    p = torch.exp2(sc - m_new[..., None])
                    alpha = torch.exp2(m - m_new)
                    l = l * alpha + p.sum(-1)
                    if vs is not None:
                        p = p * vs[b, rows].T[:, None, :]
                    hi = _bf16(p)
                    pp = hi if p_form == "bf16" else hi + _bf16(p - hi)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "kgt,tkh->kgh", pp, v[b, rows].float())
                    m = m_new
                warps.append((m, l, acc) if ran else None)
            splits.append(merge(warps))
        state = merge(splits)
        if state is not None:
            _, L, A = state
            out[b] = A / L.clamp(min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(torch.bfloat16)


def test_paged_cases_are_serve_shapes():
    """chip_smoke.py's paged phase at full width: qwen3-0.6b's 16 and the
    hybrid's 64 query heads on 8 KV heads (G <= 8, what the kernels
    take), and the all-slots case at the first eight prompts of the qwen
    serve draw, each 16 tokens into its decode, every slot active and
    inside the pool's 1,024 rows."""
    from repro_torch.configs import make_run_config
    from repro_torch.serve.engine import Request
    cs = _chip_smoke()
    qwen = make_run_config("qwen3-0.6b", "decode_32k").model
    hyb = make_run_config(cs.HYBRID, "decode_32k").model
    cases = cs.paged_cases(qwen, hyb, 0)
    assert [(label, H) for label, H, _ in cases] == [
        ("qwen heads", 16), ("hybrid heads", 64), ("all slots", 16)]
    assert qwen.num_kv_heads == hyb.num_kv_heads == 8
    assert cases[0][2] == cases[1][2] == PAGED_POS
    reqs = cs.make_requests(Request, qwen.vocab_size, 0)[:8]
    assert cases[2][2] == [len(r.prompt) + 15 for r in reqs]
    assert all(0 <= p < 1024 for p in cases[2][2])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("heads", ["qwen", "hybrid"])
def test_paged_decode_numerics(heads, kv):
    """The paged kernels' rounding, emulated on the CPU at the serve
    pool's shape (B=8, page 16, NP 64, 8 KV heads of 128, PAGED_POS;
    qwen3-0.6b's 16 query heads and the hybrid's 64; numpy
    standard-normal inputs, seed 0, q in bf16, pages in bf16 or
    quantized to int8 with ``kv_quant_ref``), against the plain versions
    ``paged_decode_ref`` / ``paged_decode_quant_ref``. The share of the
    limit ATTN_ATOL + ATTN_RTOL * |plain| that the worst element uses:

        shape                          bf16 P   P_hi + P_lo
        qwen q (8,1,16,128), bf16       7.37      0.454
        qwen, int8                      9.08      0.410
        hybrid q (8,1,64,128), bf16     6.15      0.359
        hybrid, int8                    9.95      0.456

    So the kernels feed P V the pair, with the v scale folded into P
    before the split (int8); the k scale on the fp32 score keeps the
    int8 kernel within fp32 rounding of dequantize-then-dot."""
    rng = np.random.default_rng(0)
    B, page, NP, K, hd = 8, 16, 64, 8, 128
    H = 16 if heads == "qwen" else 64
    P = 1 + B * NP
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd),
                                             np.float32)).bfloat16()
    kp, vp = (torch.from_numpy(rng.standard_normal((P, page, K, hd),
                                                   np.float32)) for _ in "kv")
    tables = torch.from_numpy(rng.permutation(np.arange(1, P))
                              .reshape(B, NP).astype(np.int32))
    pos = torch.tensor(PAGED_POS, dtype=torch.int32)
    tbl = tables.long()

    def view(x):            # the logical (B, T, ...) view of a pool
        return x[tbl].reshape((B, NP * page) + x.shape[2:])

    if kv == "int8":
        (kq, ksc), (vq, vsc) = tref.kv_quant_ref(kp), tref.kv_quant_ref(vp)
        want = tref.paged_decode_quant_ref(q, kq, vq, ksc, vsc, tables, pos)
        args = (q, view(kq), view(vq), pos)
        kw = {"ks": view(ksc), "vs": view(vsc)}
    else:
        kp, vp = kp.bfloat16(), vp.bfloat16()
        want = tref.paged_decode_ref(q, kp, vp, tables, pos)
        args, kw = (q, view(kp), view(vp), pos), {}
    pair = _share(_emulate_paged(*args, "pair", **kw), want)
    single = _share(_emulate_paged(*args, "bf16", **kw), want)
    print(f"{heads} {kv}: bf16 P {single:.3g}, P_hi + P_lo {pair:.3g}")
    assert pair <= 1            # what the kernels use: inside the limit


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
