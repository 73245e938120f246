"""fp32 compute through the attention kernels, against the JAX package.

The Pallas kernels are generic in dtype, and JAX's suite holds each of
them at fp32 to atol = rtol = 2e-5 (tests/test_kernels.py). Here the
port's four attention wrappers (``flash_attention``, ``flash_decode``,
``paged_decode``, ``paged_decode_quant``) take fp32 on the CPU, where they
run their plain versions, against JAX's kernels in interpret mode on the
same numpy inputs at that tolerance; a smoke qwen3 engine at
``compute="float32"`` (paged, int8 pages, dense ring) gives the greedy
tokens of the JAX engine with ``kernel_backend="pallas"``, its prefill
logits within 1e-4 (the fp32 model tolerance of test_torch_model.py);
``kernel_backend="pallas"`` is the port's kernel path; the kernels'
dtype contract holds on meta tensors (what the dry-run counts); and the
numerics of fp32 ``flash_attention``'s CUDA kernel, emulated here: its
tensor-core products take each fp32 operand as a TF32 pair with three
products a product (3xTF32), well under 2e-5, where a bf16 pair leaves
no margin and TF32 alone misses it; the fp32 paged decodes' at the
serve pool (three bf16 pieces of q and P over int8 pages, 3xTF32 over
fp32 pages); and fp32 ``flash_decode``'s (3xTF32) at its timed rows.
The card's side of this is in tests/test_torch_cuda.py
(``*_fp32_on_card``, ``*_fp32_split_on_card``) and chip_smoke.py's
``run_fp32``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.kernels.flash_attention import flash_attention as jax_fa
from repro.kernels.flash_decode import flash_decode as jax_fd
from repro.kernels.paged_decode import paged_decode as jax_pd
from repro.kernels.paged_decode import paged_decode_quant as jax_pdq
from repro.kernels.ref import flash_decode_ref as jax_fd_ref
from repro.kernels.ref import paged_decode_quant_ref as jax_pd_quant_ref
from repro.kernels.ref import paged_decode_ref as jax_pd_ref
from repro.models.model import build_model as jax_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import kv_quant_ref
from repro_torch.models.model import build_model as torch_model
from repro_torch.serve.engine import Request, ServeEngine

TOL = 2e-5          # JAX's fp32 kernel tolerance (tests/test_kernels.py)
MODEL_TOL = 1e-4    # fp32 logits across the frameworks (test_torch_model)
ARCH = "qwen3-0.6b"


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in shapes]


def _close(port, jax_out):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out),
                               atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the four wrappers at fp32 against the Pallas kernels (interpret mode), on
# the shapes of JAX's sweeps (tests/test_kernels.py:25-118)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,K,hd,causal", [
    (1, 128, 4, 4, 64, True), (2, 256, 4, 2, 64, True),
    (1, 256, 8, 1, 128, True), (2, 128, 2, 2, 64, False),
    (1, 384, 6, 3, 64, True)])
def test_flash_attention_fp32_matches_pallas(B, S, H, K, hd, causal):
    q, k, v = _normal(S + H, (B, S, H, hd), (B, S, K, hd), (B, S, K, hd))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    assert got.dtype == torch.float32
    _close(got, jax_fa(q, k, v, causal=causal, interpret=True))


@pytest.mark.parametrize("B,T,H,K,hd,pos", [
    (1, 256, 4, 4, 64, 255), (2, 512, 4, 2, 64, 17),
    (1, 1024, 8, 2, 128, 700), (2, 256, 2, 1, 64, 0)])
def test_flash_decode_fp32_matches_pallas(B, T, H, K, hd, pos):
    q, k, v = _normal(T + pos, (B, 1, H, hd), (B, T, K, hd), (B, T, K, hd))
    got = ops.flash_decode(*map(torch.from_numpy, (q, k, v)), pos)
    assert got.dtype == torch.float32
    _close(got, jax_fd(q, k, v, pos, interpret=True))


PAGED = [(1, 4, 4, 64, 16, 4, 8, (63,)),
         (3, 4, 2, 64, 8, 4, 16, (5, -1, 31)),
         (2, 8, 2, 128, 32, 2, 5, (0, 40)),
         (2, 2, 1, 64, 8, 8, 17, (-1, -1))]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,H,K,hd,page,NP,P,positions", PAGED)
def test_paged_decode_fp32_matches_pallas(quant, B, H, K, hd, page, NP, P,
                                          positions):
    """fp32 q over fp32 pages, and over int8 pages with their fp32 scales
    (quantized once, by the port's rule: the JAX engine's bits)."""
    q, kp, vp = _normal(NP * page + H, (B, 1, H, hd), (P, page, K, hd),
                        (P, page, K, hd))
    tables = np.random.default_rng(0).integers(1, P, (B, NP)).astype(
        np.int32)
    pos = np.asarray(positions, np.int32)
    t = [torch.from_numpy(x) for x in (q, kp, vp, tables, pos)]
    if quant:
        (kq, ks), (vq, vs) = kv_quant_ref(t[1]), kv_quant_ref(t[2])
        got = ops.paged_decode_quant(t[0], kq, vq, ks, vs, t[3], t[4])
        want = jax_pdq(q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy(),
                       tables, pos, interpret=True)
    else:
        got = ops.paged_decode(*t)
        want = jax_pd(q, kp, vp, tables, pos, interpret=True)
    assert got.dtype == torch.float32
    _close(got, want)
    for b, p in enumerate(positions):
        if p < 0:
            assert torch.all(got[b] == 0)


# ---------------------------------------------------------------------------
# the smoke qwen3 engine at fp32 compute against JAX's Pallas path
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen():
    jrun = jax_run_config(ARCH, "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"),
                          kernel_backend="pallas")
    trun = torch_run_config(ARCH, "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"),
                            kernel_backend="pallas")
    jp = jax_model(jrun).init(jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jrun, jp, trun, tp


def _greedy(cls):
    return [cls(rid=i, prompt=(np.arange(5 + 7 * i) * (i + 2) + 1) % 500,
                max_new_tokens=8, temperature=0.0, seed=3 + i)
            for i in range(3)]


@pytest.mark.parametrize("paged,kv_dtype", [(True, None), (True, "int8"),
                                            (False, None)],
                         ids=["paged", "int8", "dense"])
def test_fp32_engine_greedy_tokens_equal_jax_pallas(qwen, paged, kv_dtype):
    jrun, jp, trun, tp = qwen
    kw = dict(slots=2, max_len=48, paged=paged, page_size=8,
              kv_dtype=kv_dtype, fused_sampling=True)
    out = []
    for eng, cls in ((JEngine(jrun, jp, **kw), JRequest),
                     (ServeEngine(trun, tp, device="cpu", **kw), Request)):
        reqs = _greedy(cls)
        for r in reqs:
            eng.submit(r)
        assert eng.run_until_idle().drained
        assert all(r.done and not r.error for r in reqs)
        out.append([list(r.out) for r in reqs])
    assert out[1] == out[0]


@pytest.mark.parametrize("S", [13, 40])
def test_fp32_prefill_logits_match_jax_pallas(qwen, S):
    jrun, jp, trun, tp = qwen
    toks = np.random.default_rng(S).integers(0, 512, (1, S))
    _, jlog = jax_model(jrun).prefill(jp, {"tokens": jnp.asarray(toks,
                                                                 jnp.int32)})
    _, tlog = torch_model(trun).prefill(tp, {"tokens": torch.tensor(toks)})
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def test_pallas_backend_is_the_kernel_path(qwen):
    """``kernel_backend="pallas"`` (the JAX package's name for its kernels)
    builds the port's kernel path: the smoke prefill equals the "auto"
    one bit for bit, and ops take "auto"; an unknown name is refused."""
    from repro_torch.models.model import ops_backend
    _, _, trun, tp = qwen
    assert ops_backend(trun) == "auto"
    toks = torch.tensor(np.random.default_rng(5).integers(0, 512, (1, 17)))
    _, a = torch_model(trun).prefill(tp, {"tokens": toks})
    _, b = torch_model(trun.replace(kernel_backend="auto")).prefill(
        tp, {"tokens": toks})
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="kernel_backend"):
        ops_backend(trun.replace(kernel_backend="triton"))


# ---------------------------------------------------------------------------
# the dtype contract, on meta tensors (as the dry-run checks it)
# ---------------------------------------------------------------------------
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _contract(name, dq, dkv):
    """Call the kernel's check with q of ``dq`` and the cache or pages of
    ``dkv`` (qwen's smoke heads)."""
    if name == "flash_attention":
        return ops.check_flash_attention(
            _meta((1, 40, 4, 32), dq), _meta((1, 40, 2, 32), dkv),
            _meta((1, 40, 2, 32), dkv))
    if name == "flash_decode":
        return ops.check_flash_decode(
            _meta((2, 1, 4, 32), dq), _meta((2, 256, 2, 32), dkv),
            _meta((2, 256, 2, 32), dkv))
    tables = _meta((2, 4), torch.int32)
    pos = _meta((2,), torch.int32)
    return ops._check_paged(_meta((2, 1, 4, 32), dq),
                            _meta((9, 16, 2, 32), dkv),
                            _meta((9, 16, 2, 32), dkv), tables, pos,
                            dq)     # the pages of q's dtype, as the wrapper


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "paged_decode"])
def test_kernel_contract_takes_bf16_and_fp32_only(name):
    for dt in (torch.bfloat16, torch.float32):
        _contract(name, dt, dt)
    for dq, dkv in ((torch.float16, torch.float16),
                    (torch.float32, torch.bfloat16),
                    (torch.bfloat16, torch.float32),
                    (torch.float64, torch.float64)):
        with pytest.raises(TypeError):
            _contract(name, dq, dkv)


def test_quant_contract_takes_bf16_and_fp32_q():
    pages = _meta((9, 16, 2, 32), torch.int8)
    tables, pos = _meta((2, 4), torch.int32), _meta((2,), torch.int32)
    for dq in (torch.bfloat16, torch.float32):
        ops._check_paged(_meta((2, 1, 4, 32), dq), pages, pages, tables,
                         pos, torch.int8)
    with pytest.raises(TypeError):
        ops._check_paged(_meta((2, 1, 4, 32), torch.float16), pages, pages,
                         tables, pos, torch.int8)


# ---------------------------------------------------------------------------
# why fp32 flash_attention's tensor-core products are 3xTF32: the numerics
# of the kernel's pieces, emulated (fp32 pieces, products in float64, each
# product's three-term sum rounded to fp32)
# ---------------------------------------------------------------------------
def _pair(x):
    """x (fp32) as hi + lo, each rounded to bf16, as float64."""
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return hi.double(), lo.double()


@pytest.mark.parametrize("S,H,K,hd", [(384, 16, 8, 128), (384, 32, 32, 96)],
                         ids=["qwen", "phi3"])
def test_fp32_attention_bf16_pairs_leave_no_margin(S, H, K, hd):
    """Causal attention with q, k, v and P each entered as a bf16 pair and
    three products a step (hi hi + hi lo + lo hi, fp32 sums), emulated in
    float64, against the plain fp32 version: it uses more than half of
    the fp32 limit 2e-5 + 2e-5 |plain| at qwen's and phi3's prompts (a
    pair holds a value to 2^-16 of it), while exact products of the fp32
    inputs (the CUDA cores' FMA) use under a tenth."""
    q, k, v = (torch.from_numpy(x) for x in _normal(
        hd, (1, S, H, hd), (1, S, K, hd), (1, S, K, hd)))
    want = ops.flash_attention(q, k, v)
    G = H // K
    mask = torch.ones((S, S), dtype=torch.bool).tril()

    def attend(scores, pv):
        s = (scores / hd ** 0.5).masked_fill(~mask, float("-inf"))
        return pv(torch.softmax(s, -1).float())

    kk, vv = (x.repeat_interleave(G, 2) for x in (k, v))
    qk = "bshd,bthd->bhst"
    ov = "bhst,bthd->bshd"

    def pair3(a, b, eq):
        (ah, al), (bh, bl) = _pair(a), _pair(b)
        return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, al, bh)).float().double()

    paired = attend(pair3(q, kk, qk), lambda p: pair3(p, vv, ov)).float()
    exact = attend(torch.einsum(qk, q.double(), kk.double()),
                   lambda p: torch.einsum(ov, p.double(),
                                          vv.double())).float()
    lim = TOL + TOL * want.abs()
    assert float(((paired - want).abs() / lim).max()) > 0.5
    assert float(((exact - want).abs() / lim).max()) < 0.1


def _tf32(x):
    """x (fp32) rounded to TF32 as the kernel rounds it (cvt.rna's
    rounding): add 0x1000 to the bit pattern, clear the low 13 bits."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_pair(x):
    """x (fp32) as hi + lo, each rounded to TF32, as float64."""
    hi = _tf32(x)
    lo = _tf32(x - hi)
    return hi.double(), lo.double()


def _emulated_attention(S, H, K, hd, split, three, q_scale=1.0):
    """Causal attention on seeded fp32 inputs (q times ``q_scale``) with
    q, k, v and P each entered as the pieces hi, lo of ``split``, a
    product as hi hi (+ hi lo + lo hi if ``three``) in float64, its sum
    rounded to fp32, the softmax in float64; returns (it, the port's
    plain fp32 version, the same attention in float64 throughout)."""
    q, k, v = (torch.from_numpy(x) for x in _normal(
        hd, (1, S, H, hd), (1, S, K, hd), (1, S, K, hd)))
    q = q * q_scale
    want = ops.flash_attention(q, k, v)
    G = H // K
    mask = torch.ones((S, S), dtype=torch.bool).tril()
    kk, vv = (x.repeat_interleave(G, 2) for x in (k, v))

    def split64(x):
        return x.double(), torch.zeros((), dtype=torch.float64)

    def product(a, b, eq, split=split, three=three):
        (ah, al), (bh, bl) = split(a), split(b)
        terms = [(ah, bh)] + ([(ah, bl), (al, bh)] if three else [])
        return sum(torch.einsum(eq, x, y) for x, y in terms)

    def attend(product):
        s = product(q, kk, "bshd,bthd->bhst").double() / hd ** 0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        return product(p, vv, "bhst,bthd->bshd")

    def emulated(a, b, eq):
        return product(a.float(), b, eq).float()

    exact = attend(lambda a, b, eq: product(a, b, eq, split64, False))
    return attend(emulated), want, exact


def _share(got, want):
    """The largest share of the fp32 limit 2e-5 + 2e-5 |want| used."""
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


@pytest.mark.parametrize("S,H,K,hd", [(384, 16, 8, 128), (384, 32, 32, 96),
                                      (640, 14, 2, 64)],
                         ids=["qwen", "phi3", "internvl2"])
def test_fp32_attention_tf32_triples_hold_the_limit(S, H, K, hd):
    """The fp32 kernel's numerics: q, k, v and P each entered as a TF32
    pair (hi = tf32(x), lo = tf32(x - hi), rounded to nearest with ties
    away) and three products a product (lo hi + hi lo + hi hi), emulated
    in float64, use under a fifth of the fp32 limit at qwen's, phi3's and
    internvl2's prompts (a TF32 pair holds a value to about 2^-22; the
    card reads 0.03-0.05 of it), while TF32 alone, one product of the hi
    pieces, misses the limit many times over."""
    triple, want, _ = _emulated_attention(S, H, K, hd, _tf32_pair, True)
    alone, _, _ = _emulated_attention(S, H, K, hd, _tf32_pair, False)
    assert _share(triple, want) < 0.2
    assert _share(alone, want) > 1


@pytest.mark.parametrize("q_scale,bound", [(4.0, 0.2), (16.0, 0.5)])
@pytest.mark.parametrize("S,H,K,hd", [(384, 16, 8, 128), (384, 32, 32, 96),
                                      (640, 14, 2, 64)],
                         ids=["qwen", "phi3", "internvl2"])
def test_fp32_attention_tf32_triples_under_sharp_scores(S, H, K, hd,
                                                        q_scale, bound):
    """The same emulated 3xTF32 products with q alone scaled by 4 and by
    16, so every score grows by that factor and the softmax sharpens
    (each score's error through exp2 grows with it). Held against the
    attention in float64 throughout: under ``bound`` of the fp32 limit
    2e-5 + 2e-5 |exact| (0.06-0.09 read at 4, 0.26-0.36 at 16) and no
    farther from it than the plain fp32 version, which itself uses
    0.22-0.32 of that limit at 4 and 1.1-1.7 at 16. So under sharp
    softmaxes the limit against the plain version cannot hold for any
    fp32 implementation; the card's cases hold the kernel against
    float64 the same way (tests/test_torch_cuda.py)."""
    triple, want, exact = _emulated_attention(S, H, K, hd, _tf32_pair,
                                              True, q_scale)
    exact_share = _share(triple.double(), exact)
    assert exact_share < bound
    assert exact_share <= _share(want.double(), exact)


# ---------------------------------------------------------------------------
# why the fp32 paged decodes' tensor-core products are three bf16 pieces of
# q and P (int8 pages) and 3xTF32 (fp32 pages): their numerics, emulated at
# the serve pool's shape and held against the JAX package's paged decodes
# in fp32 (its plain references, which its own suite holds the Pallas
# kernels to: Pallas in interpret mode takes minutes at this shape)
# ---------------------------------------------------------------------------
SERVE_POS = (1023, -1, 600, 15, 0, 384, 200, -1)   # chip_smoke's PAGED_POS


def _bf16_pieces(x, n):
    """x (fp32) as n bf16 pieces, each rounded to nearest from what the
    pieces before it leave over (exact in fp32), as float64."""
    out = []
    for _ in range(n):
        piece = x.to(torch.bfloat16).float()
        out.append(piece.double())
        x = x - piece
    return out


def _serve_pool(G, seed):
    """The serve engine's pool at B 8, page 16, NP 64, qwen3-0.6b's 8 KV
    heads of 128, G query heads each, at SERVE_POS: numpy q, k/v pages
    (513 pages, each slot's table a distinct run of a permutation)."""
    B, page, NP, K, hd = 8, 16, 64, 8, 128
    P = 1 + B * NP
    q, kp, vp = _normal(seed, (B, 1, G * K, hd), (P, page, K, hd),
                        (P, page, K, hd))
    tables = np.random.default_rng(seed).permutation(
        np.arange(1, P)).reshape(B, NP).astype(np.int32)
    return q, kp, vp, tables, np.asarray(SERVE_POS, np.int32)


def _emulated_paged(quant, G, splits, seed=30):
    """The paged decode over ``_serve_pool`` with q, k, v and P entered as
    the pieces of each of ``splits`` (each returns a list: the leading
    piece, then the corrections; an int8 value is exact and stays whole),
    products in float64, the leading products' sum and the corrections'
    sum each rounded to fp32 and added in fp32; the k scale on the score,
    the v scale on P (int8 pages), the softmax in float64. Returns ([one
    output per split], JAX's fp32 reference)."""
    q, kp, vp, tables, pos = _serve_pool(G, seed)
    t = [torch.from_numpy(x) for x in (q, kp, vp)]
    if quant:
        (kq, ks), (vq, vs) = kv_quant_ref(t[1]), kv_quant_ref(t[2])
        want = jax_pd_quant_ref(q, kq.numpy(), vq.numpy(), ks.numpy(),
                                vs.numpy(), tables, pos)
        pages = (kq.double(), vq.double())
    else:
        want = jax_pd_ref(q, kp, vp, tables, pos)
        pages = (t[1], t[2])
    B, _, H, hd = q.shape
    page, K = kp.shape[1], kp.shape[2]
    T = tables.shape[1] * page
    tbl = torch.from_numpy(tables).long()

    def rows(x):                      # (P, page, K, ...) -> (B, T, K, ...)
        return x[tbl].reshape(B, T, K, *x.shape[3:])
    k, v = (rows(x) for x in pages)

    valid = (torch.arange(T)[None, :] <= torch.from_numpy(pos).long()[:, None])
    outs = []
    for split in splits:
        def product(a, b, eq):
            pa = split(a)
            pb = [b] if quant else split(b)
            lead = torch.einsum(eq, pa[0], pb[0]).float()
            corr = sum(torch.einsum(eq, x, y) for i, x in enumerate(pa)
                       for j, y in enumerate(pb) if 0 < i + j < 2
                       or (quant and i > 0)).float()
            return lead + corr

        s = product(t[0].reshape(B, K, G, hd), k, "bkgh,btkh->bkgt")
        if quant:
            s = s * rows(ks).permute(0, 2, 1)[:, :, None, :]
        s = (s.double() / hd ** 0.5).masked_fill(~valid[:, None, None, :],
                                                 float("-inf"))
        p = torch.softmax(s, -1).nan_to_num(0.0).float()
        if quant:
            p = p * rows(vs).permute(0, 2, 1)[:, :, None, :]
        outs.append(product(p, v, "bkgt,btkh->bkgh").reshape(B, 1, H, hd))
    return outs, torch.from_numpy(np.array(want))


def _pieces(n):
    return lambda x: _bf16_pieces(x.float(), n)


@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("quant", [True, False], ids=["int8", "fp32"])
def test_fp32_paged_tensor_core_pieces_hold_the_limit(quant, G):
    """The fp32 paged kernels' numerics at the serve pool (B 8, page 16,
    NP 64, 8 KV heads of 128, G 2 and 8, the serve phase's positions),
    against JAX's paged_decode / paged_decode_quant in fp32. Int8 pages
    (exact in bf16): q and P as three bf16 pieces, q1 k in one sum and
    q2 k + q3 k in another, the same for P V; they use 0.013 (G 2) and
    0.024 (G 8) of the fp32 limit 2e-5 + 2e-5 |want|. fp32 pages: 3xTF32,
    every operand a TF32 pair (``_tf32``'s rounding), hi hi in one sum and
    hi lo + lo hi in another; 0.014 and 0.027. Each at most 0.25 of the
    limit and under a third of what a bf16 pair of each split operand
    uses: 0.17 and 0.32 (int8 pages), 0.45 and 0.53 (fp32 pages), before
    the tensor core's truncating sums, which the card adds to either."""
    split = _pieces(3) if quant else (lambda x: list(_tf32_pair(x.float())))
    (got, pair), want = _emulated_paged(quant, G, [split, _pieces(2)])
    share, pair_share = _share(got, want), _share(pair, want)
    print(f"{'int8' if quant else 'fp32'} pages G {G}: {share:.4f} of the "
          f"fp32 limit, a bf16 pair {pair_share:.4f}")
    assert share <= 0.25
    assert 3 * share < pair_share
    for b, p in enumerate(SERVE_POS):
        if p < 0:
            assert torch.all(got[b] == 0)


# ---------------------------------------------------------------------------
# fp32 flash_decode's tensor-core products (3xTF32, the paged decode's tile
# over a dense cache), emulated at chip_smoke.py's fp32 rows and held
# against the JAX package's plain flash_decode in fp32
# ---------------------------------------------------------------------------
def _emulated_decode(H, pos, splits, seed=31):
    """flash_decode over seeded fp32 q (8,1,H,128), k and v (8,1024,8,128)
    at ``pos``, with q, k, v and P entered as the pieces of each of
    ``splits`` (a list: the leading piece, then the correction), products
    in float64, the leading product's sum and the cross terms' sum each
    rounded to fp32 and added in fp32, the softmax in float64. Returns
    ([one output per split], JAX's fp32 reference)."""
    B, T, K, hd = 8, 1024, 8, 128
    q, k, v = _normal(seed, (B, 1, H, hd), (B, T, K, hd), (B, T, K, hd))
    want = torch.from_numpy(np.array(jax_fd_ref(q, k, v, pos)))
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    valid = torch.arange(T) <= pos
    outs = []
    for split in splits:
        def product(a, b, eq):
            (ah, al), (bh, bl) = split(a), split(b)
            lead = torch.einsum(eq, ah, bh).float()
            return lead + (torch.einsum(eq, ah, bl)
                           + torch.einsum(eq, al, bh)).float()

        s = product(q.reshape(B, K, H // K, hd), k, "bkgh,btkh->bkgt")
        s = (s.double() / hd ** 0.5).masked_fill(~valid, float("-inf"))
        p = torch.softmax(s, -1).float()
        outs.append(product(p, v, "bkgt,btkh->bkgh").reshape(B, 1, H, hd))
    return outs, want


@pytest.mark.parametrize("pos", [511, 1023])
@pytest.mark.parametrize("H", [16, 64], ids=["G2", "G8"])
def test_fp32_decode_tf32_triples_hold_the_limit(H, pos):
    """fp32 flash_decode's numerics at chip_smoke.py's fp32 rows (q
    (8,1,16,128) over k/v (8,1024,8,128), qwen3-0.6b's heads, G 2) and at
    G 8 (q (8,1,64,128)), pos 511 and 1023, against JAX's flash_decode_ref
    in fp32: 3xTF32, q, k, v and P each a TF32 pair (``_tf32``'s
    rounding), hi hi in one sum and hi lo + lo hi in another, uses
    0.0093-0.0141 (G 2) and 0.0119-0.0142 (G 8) of the fp32 limit 2e-5 +
    2e-5 |want|; a bf16 pair of each operand the same way uses
    0.083-0.137 and 0.103-0.137. The emulation is held to at most 0.25 of
    the limit and to under a third of the bf16 pair's share, before the
    tensor core's truncating sums, which the card adds to either (the
    card's kernel reads 0.0058-0.0094)."""
    tf32 = (lambda x: list(_tf32_pair(x.float())))
    (got, pair), want = _emulated_decode(H, pos, [tf32, _pieces(2)])
    share, pair_share = _share(got, want), _share(pair, want)
    print(f"flash_decode G {H // 8} pos {pos}: {share:.4f} of the fp32 "
          f"limit, a bf16 pair {pair_share:.4f}")
    assert share <= 0.25
    assert 3 * share < pair_share
