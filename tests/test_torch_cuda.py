"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the attention kernels (``flash_attention``, ``flash_decode``,
the paged decodes) within 1e-4 + 2**-6 * |plain| elementwise on bf16
inputs, two bf16 steps of the value (kernel and plain version each round
an fp32 result to bf16 once, after sums taken in other orders, so they
may differ by one step), and within JAX's fp32 tolerance, atol = rtol =
2e-5, on fp32 inputs (``flash_attention`` and the paged decode over
fp32 pages as 3xTF32 products on the tensor cores, ``flash_decode`` the
same way, the paged decode over int8 pages as three bf16 pieces of q and
P, each at most a quarter of that limit at the main shapes; sums in other
orders than the plain version's);
``ssm_scan`` within 1e-4 * max |plain| for y and for the
state (the plain version computes in fp32; the kernel's tensor-core
products take each fp32 operand as a bf16 pair and sum in fp32 in other
orders, 0.03-0.08 of the limit in ``test_ssm_scan_numerics``); sampling
and the staging kernels (``qdma_pack``, ``qdma_pack_rows``,
``qdma_unpack``, ``qdma_digest``) are bit-exact.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only numpy and the
    standard library at the top): its staging test leaves and
    ``bits_equal``."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _paged_inputs(seed, B, H, K, hd, page, NP, P, positions):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd), np.float32)
    kp = rng.standard_normal((P, page, K, hd), np.float32)
    vp = rng.standard_normal((P, page, K, hd), np.float32)
    tables = rng.integers(1, P, (B, NP)).astype(np.int32)
    return q, kp, vp, tables, np.asarray(positions, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("S,causal", [(7, True), (200, True), (130, False)])
def test_flash_attention_kernel_on_card(cuda, S, causal):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((2, S, 16, 128), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, S, 8, 128), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, S, 8, 128), generator=g, device=cuda).bfloat16()
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2 ** -6)


def _attn_inputs(cuda, seed, B, S, T, H, K, hd, dtype=torch.bfloat16):
    """q (B,S,H,hd), k and v (B,T,K,hd) on the card in ``dtype``, from
    numpy."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(cuda).to(dtype)
                 for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,H,K,hd,causal", [
    (1, 1, 64, 8, 128, True),        # GQA 64/8: one row, one key
    (63, 63, 64, 8, 128, True),      # one ragged query and kv tile
    (65, 65, 64, 8, 128, True),      # a full tile and one row
    (600, 600, 64, 8, 128, True),    # qwen's longest prompt, hybrid heads
    (600, 600, 16, 8, 64, True),     # hd 64
    (65, 65, 8, 8, 64, True),        # MHA at hd 64
    (100, 300, 16, 8, 128, False),   # S < T, not causal
    (300, 77, 64, 8, 64, False),     # S > T, not causal, hd 64
])
def test_flash_attention_tensor_core_shapes(cuda, S, T, H, K, hd, causal):
    """The tensor-core kernel at the edges of its tiles, GQA 64/8 and hd
    64: within two bf16 steps of the plain version, and bit-identical on
    a second call (no atomics)."""
    q, k, v = _attn_inputs(cuda, S + T + H + hd, 1, S, T, H, K, hd)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2 ** -6)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,H,K,hd,causal", [
    (384, 384, 32, 32, 96, True),    # phi3-mini's prefill: hd 96, G = 1
    (600, 600, 32, 32, 96, True),
    (130, 130, 32, 32, 96, False),   # hd 96, not causal
    (200, 50, 16, 16, 96, False),    # hd 96, a cross attention (T < S)
    (300, 300, 16, 16, 64, False),   # seamless's encoder (S = T), G = 1
    (300, 75, 16, 16, 64, False),    # seamless's cross attention, T = S/4
    (356, 356, 14, 2, 64, True),     # internvl2: 256 patches + 100, G = 7
    (200, 200, 56, 8, 128, True),    # arctic: G = 7 at hd 128
    (256, 256, 16, 16, 128, True),   # olmoe: MHA at hd 128
    (40, 40, 4, 4, 16, True),        # the smoke configs' hd 16
])
def test_flash_attention_family_shapes(cuda, S, T, H, K, hd, causal):
    """The attention kernel at the other families' shapes: any hd that is
    a multiple of 8 up to 128 (its columns at or past hd zero-filled in
    the 128-wide tiles), G = 1 and G = 7, causal and not, T != S: within
    two bf16 steps of the plain version, the same bits again."""
    q, k, v = _attn_inputs(cuda, S + T + H + hd, 1, S, T, H, K, hd)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2 ** -6)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [4, 100, 136, 256])
def test_flash_attention_refuses_other_head_dims(cuda, hd):
    """A head dim that is no multiple of 8, or over 128, is refused before
    any launch."""
    q, k, v = _attn_inputs(cuda, hd, 1, 8, 8, 2, 2, hd)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="flash_attention kernel"):
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("G,hd", [(1, 128), (2, 128), (8, 128), (8, 64),
                                  (4, 72), (1, 96), (7, 96), (7, 64),
                                  (7, 128)])
@pytest.mark.parametrize("pos", [0, 63, 64, 1023])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_decode_tensor_core_shapes(cuda, request, dtype, G, hd, pos):
    """flash_decode with G query heads per KV head (the mma's N of 8, part
    unused for G < 8) and hd padded to the mma's 16 (72), on bf16 inputs
    and on fp32 ones (the 3xTF32 kernel, held to JAX's fp32 limit with the
    plain version in full fp32): the position as an int, an int32 and an
    int64 device tensor gives the same bits within the limit, a second
    call the same bits, and NaN in the rows past pos changes nothing (they
    are never read)."""
    B, T, K = 2, 1024, 4
    fp32 = dtype == torch.float32
    if fp32:
        request.getfixturevalue("full_fp32")
    q, k, v = _attn_inputs(cuda, pos + G + hd, B, 1, T, G * K, K, hd, dtype)
    want = ops.flash_decode(q, k, v, pos, backend="ref")
    got = ops.flash_decode(q, k, v, pos)
    assert got.dtype == dtype
    if fp32:
        torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=2 ** -6)
    for pos_dtype in (torch.int32, torch.int64):
        p = torch.tensor(pos, dtype=pos_dtype, device=cuda)
        assert torch.equal(got, ops.flash_decode(q, k, v, p))
    assert torch.equal(got, ops.flash_decode(q, k, v, pos))
    k[:, pos + 1:] = float("nan")
    v[:, pos + 1:] = float("nan")
    assert torch.equal(got, ops.flash_decode(q, k, v, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_kernel_on_card(cuda, quant):
    args = _paged_args(cuda, quant, 5, B=8, G=2, K=8, hd=128, page=16, NP=8,
                       positions=(0, -1, 15, 16, 127, 70, -1, 33), P=40)
    fn = ops.paged_decode_quant if quant else ops.paged_decode
    got, want = fn(*args), fn(*args, backend="ref")
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2 ** -6)
    assert torch.all(got[1] == 0) and torch.all(got[6] == 0)
    assert torch.equal(got, fn(*args))     # no atomics: same bits again


def _paged_args(cuda, quant, seed, B, G, K, hd, page, NP, positions,
                P=None, distinct=False, dtype=torch.bfloat16):
    """The wrapper's arguments on the card from ``_paged_inputs``: a pool
    of P pages (B * NP + 1 by default), table ids drawn with repeats
    across and within slots, or with ``distinct`` each slot's table a
    run of a permutation; q and the pages in ``dtype``, or int8 pages
    with their scales when ``quant``."""
    P = P or B * NP + 1
    q, kp, vp, tables, pos = _paged_inputs(seed, B, G * K, K, hd, page, NP,
                                           P, positions)
    if distinct:
        tables = np.random.default_rng(seed).permutation(
            np.arange(1, P))[:B * NP].reshape(B, NP).astype(np.int32)
    q = torch.from_numpy(q).to(dtype).to(cuda)
    t, p = torch.from_numpy(tables).to(cuda), torch.from_numpy(pos).to(cuda)
    kp, vp = torch.from_numpy(kp).to(cuda), torch.from_numpy(vp).to(cuda)
    if quant:
        (kq, ks), (vq, vs) = tref.kv_quant_ref(kp), tref.kv_quant_ref(vp)
        return (q, kq, vq, ks, vs, t, p)
    return (q, kp.to(dtype), vp.to(dtype), t, p)


def _poison_unread(args, quant):
    """NaN (int8 pages: NaN scales and garbage bytes) in every pool row
    that no slot reads: rows past pos[b] of a slot's last page and the
    pages its table names past pos[b], unless another slot reads them."""
    tables, pos = args[-2].cpu(), args[-1].cpu()
    P, page = args[1].shape[:2]
    read = torch.zeros((P, page), dtype=torch.bool)
    for b in range(tables.shape[0]):
        rows = torch.arange(max(0, min(int(pos[b]) + 1,
                                       tables.shape[1] * page)))
        read[tables[b, rows // page].long(), rows % page] = True
    unread = (~read).to(args[1].device)
    if quant:
        args[1][unread] = 127
        args[2][unread] = -127
        args[3][unread] = float("nan")
        args[4][unread] = float("nan")
    else:
        args[1][unread] = float("nan")
        args[2][unread] = float("nan")


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", [
    # split edges at NP 64, page 16 (8 pages = 128 rows a block)
    dict(G=2, hd=128, page=16, NP=64, positions=(0, 127, 128, 1023)),
    dict(G=2, hd=128, page=16, NP=64, positions=(129, -1, 255, 256, 1000,
                                                 -5, 511, 64)),
    # NP 128: 16 pages = 256 rows a block, four tiles double-buffered
    dict(G=2, hd=128, page=16, NP=128, positions=(2047, 1024, 300, -1)),
    # pages of 8 and 32 rows
    dict(G=2, hd=128, page=8, NP=64, positions=(511, 7, 8, 200)),
    dict(G=2, hd=128, page=32, NP=64, positions=(2047, 31, 32, 1500)),
    # G 1 and 8, hd 64
    dict(G=1, hd=128, page=16, NP=64, positions=(1023, 600, 0, -1)),
    dict(G=8, hd=128, page=16, NP=64, positions=(1023, 600, 15, -1)),
    dict(G=8, hd=64, page=16, NP=64, positions=(1023, 77, 128, 0)),
    dict(G=2, hd=64, page=16, NP=32, positions=(511, 300, 16, -1)),
    # page ids repeated across and within slots
    dict(G=2, hd=128, page=16, NP=64, positions=(1023, 700, 64, -1),
         distinct=False),
    # pages longer than a 64-row tile, one-row pages, hd 256 and 32
    dict(G=2, hd=128, page=128, NP=8, positions=(1023, 130, 127, 64)),
    dict(G=4, hd=64, page=1, NP=256, positions=(255, 128, 127, 0)),
    dict(G=2, hd=256, page=16, NP=32, positions=(511, 200, -1, 16)),
    dict(G=4, hd=32, page=16, NP=32, positions=(511, 129, 5, -1)),
    # the other families: phi3's hd 96 at G 1, internvl2's G 7 at hd 64,
    # arctic's G 7 at hd 128, hd 96 at G 7
    dict(G=1, hd=96, page=16, NP=64, positions=(1023, 383, 0, -1)),
    dict(G=7, hd=64, page=16, NP=64, positions=(1023, 356, 255, -1)),
    dict(G=7, hd=128, page=16, NP=64, positions=(1023, 600, 16, -1)),
    dict(G=7, hd=96, page=16, NP=32, positions=(511, 200, 15, -1)),
], ids=["edges", "edges2", "np128", "page8", "page32", "g1", "g8",
        "g8_hd64", "hd64", "repeat", "page128", "page1", "hd256", "hd32",
        "g1_hd96", "g7_hd64", "g7_hd128", "g7_hd96"])
def test_paged_decode_split_shapes(cuda, full_fp32, quant, case, q_dtype):
    """The page-split kernels at the edges of their splits and tiles, pages
    of 1 to 128 rows, G 1/2/4/8 and hd 32 to 256, under bf16 q and under
    fp32 q (fp32 pages, or int8 pages: the tensor-core kernels of three
    bf16 pieces and of 3xTF32): within two bf16 steps of the plain
    version (fp32 q: JAX's fp32 limit), inactive rows exactly zero, the
    same bits on a second call, and the same bits with NaN (int8: NaN
    scales) in every row no slot reads (rows past pos[b] are zero-filled,
    never read)."""
    args = _paged_args(cuda, quant, 7 + case["NP"] + case["G"],
                       len(case["positions"]), case["G"], 4, case["hd"],
                       case["page"], case["NP"], case["positions"],
                       distinct=case.get("distinct", True), dtype=q_dtype)
    fn = ops.paged_decode_quant if quant else ops.paged_decode
    got, want = fn(*args), fn(*args, backend="ref")
    if q_dtype == torch.float32:
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=2 ** -6)
    for b, p in enumerate(case["positions"]):
        if p < 0:
            assert torch.all(got[b] == 0)
    assert torch.equal(got, fn(*args))
    _poison_unread(args, quant)
    assert torch.equal(got, fn(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 16])
@pytest.mark.parametrize("pos", [0, 511, 1023])
def test_flash_decode_kernel_on_card(cuda, H, pos):
    g = torch.Generator(device=cuda).manual_seed(pos + H)
    q = torch.randn((4, 1, H, 128), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((4, 1024, 8, 128), generator=g,
                        device=cuda).bfloat16() for _ in "kv")
    want = ops.flash_decode(q, k, v, pos, backend="ref")
    for p in (pos, torch.tensor(pos, device=cuda)):
        got = ops.flash_decode(q, k, v, p)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=2 ** -6)
    assert torch.equal(got, ops.flash_decode(q, k, v, pos))   # no atomics
    # rows past pos are never read: poisoning them changes nothing
    k[:, pos + 1:] = float("nan")
    assert torch.equal(got, ops.flash_decode(q, k, v, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,hd,N,chunk", [
    (1, 100, 8, 64, 128, 128),     # one chunk of 100 (a short prompt)
    (2, 512, 8, 64, 128, 128),     # four chunks at the published widths
    (2, 48, 4, 16, 16, 16),        # the smoke twin's widths
    (1, 5, 2, 64, 128, 128)])      # Q = 5
def test_ssm_scan_kernel_on_card(cuda, dtype, B, S, H, hd, N, chunk):
    g = torch.Generator(device=cuda).manual_seed(S + H)
    x = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dtype)
    b, c = (torch.randn((B, S, N), generator=g, device=cuda).to(dtype)
            for _ in "bc")
    la = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=cuda))
    y, st = ops.ssm_scan(x, b, c, la, chunk=chunk)
    wy, wst = ops.ssm_scan(x, b, c, la, chunk=chunk, backend="ref")
    for got, want in ((y, wy), (st, wst)):
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    with pytest.raises(ValueError, match="chunk rule"):
        ops.ssm_scan(x[:, :S - 1], b[:, :S - 1], c[:, :S - 1],
                     la[:, :S - 1], chunk=min(chunk, S - 2))


@pytest.mark.cuda
def test_fused_sample_kernel_bit_exact_on_card(cuda):
    V, B = 151_936, 8
    g = torch.Generator(device=cuda).manual_seed(0)
    logits = torch.randn((B, V), generator=g, device=cuda) * 3
    temp = torch.tensor([0, .8, .8, 1.5, 0, .8, .3, 1.], device=cuda)
    top_k = torch.tensor([0, 0, 50, 0, 0, 1, 50, 100],
                         dtype=torch.int32, device=cuda)
    keys = torch.randint(0, 2**31 - 1, (B, 3), generator=g, device=cuda,
                         dtype=torch.int32)
    got = ops.fused_sample(logits, temp, top_k, keys, vocab_size=V - 64)
    want = ops.fused_sample(logits, temp, top_k, keys, vocab_size=V - 64,
                            backend="ref")
    assert torch.equal(got, want)


def _scan_case(cuda, seed, B, S, H, hd, N, dtype):
    """x, B and C standard normal in ``dtype``, log_a = -softplus(N(0,1))
    (the steepest decays the model gives), on the card from numpy."""
    rng = np.random.default_rng(seed)
    x, b, c = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda).to(dtype)
               for shape in ((B, S, H, hd), (B, S, N), (B, S, N)))
    la = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H), np.float32)).to(cuda))
    return x, b, c, la


def _check_scan(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,N,chunk,dtype", [
    (1, 1024, 8, 64, 128, 128, torch.bfloat16),  # a cluster of 8 chunks
    (1, 2048, 4, 64, 128, 128, torch.bfloat16),  # 2 chunks a block
    (1, 1280, 2, 64, 128, 128, torch.bfloat16),  # 10 chunks: 5 runs of 2
    (1, 1152, 2, 64, 128, 128, torch.float32),   # 9: the last run 1 chunk
    (4, 384, 8, 64, 128, 128, torch.bfloat16),   # the generate prefill
    (1, 5, 8, 64, 128, 128, torch.bfloat16),     # Q = 5: one padded tile
    (3, 10, 6, 64, 128, 5, torch.bfloat16),      # Q = 5 over a cluster
    (2, 48, 4, 16, 16, 16, torch.bfloat16),      # the smoke twin's widths
    (2, 48, 4, 16, 16, 16, torch.float32),
    (1, 512, 8, 64, 128, 128, torch.float32),    # fp32 inputs, 4 chunks
    (2, 100, 8, 64, 128, 128, torch.float32),    # fp32, one chunk
    (1, 60, 3, 20, 36, 20, torch.bfloat16),      # widths off 16-byte runs
])
def test_ssm_scan_tensor_core_shapes(cuda, B, S, H, hd, N, chunk, dtype):
    """The tensor-core scan at its edges: clusters of up to 8 chunk runs,
    several chunks a block, padded tiles; within 1e-4 * max |plain| for
    y and the state, and the same bits on a second call."""
    args = _scan_case(cuda, S + H + hd, B, S, H, hd, N, dtype)
    got = ops.ssm_scan(*args, chunk=chunk)
    _check_scan(got, ops.ssm_scan(*args, chunk=chunk, backend="ref"))
    again = ops.ssm_scan(*args, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _split_edges(V, row):
    """The first index of each vocab range after the first in row ``row``
    of a contiguous (B, V) fp32 tensor that starts on a 16-byte boundary,
    as fused_sample.cu's launcher splits it: at most 16 ranges of at
    least 4,096 entries, in runs of whole float4s from the row's first
    16-byte boundary, ``head`` entries in."""
    head = (4 - row * V % 4) % 4
    nsplit = min(16, max(1, -(-V // 4096)))
    per4 = -(-(V // 4) // nsplit) + 1
    return [head + 4 * per4 * r for r in range(1, nsplit)
            if head + 4 * per4 * r < V]


def _sample_case(cuda, B, V, seed, noisy=True):
    g = torch.Generator(device=cuda).manual_seed(seed)
    z = torch.randn((B, V), generator=g, device=cuda) * 3
    keys = torch.randint(0, 2**31 - 1, (B, 4), generator=g, device=cuda,
                         dtype=torch.int32)
    keys[:, 3] = (torch.arange(B, device=cuda) % 2 == 1) & noisy
    return z, keys


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8, 64])
@pytest.mark.parametrize("V", [65_536, 151_936, 50_257, 7, 256_256,
                               128_256, 50_304, 32_128, 151_680])
def test_fused_sample_split_rows(cuda, B, V):
    """Rows split over a cluster: bit-exact against the plain version at
    the hybrid's and qwen's vocabularies, at the other families' padded
    vocabularies (seamless's 256,256, the widest; llama3's 128,256;
    internvl2's 151,680; olmoe's and xlstm's 50,304; phi3's 32,128) and
    at odd
    ones (rows that start off a 16-byte boundary), greedy and noisy rows
    alike."""
    z, keys = _sample_case(cuda, B, V, B * V)
    want = ops.sample_rows(z, keys, backend="ref")
    got = ops.sample_rows(z, keys)
    assert torch.equal(got, want)
    assert torch.equal(got, ops.sample_rows(z, keys))


@pytest.mark.cuda
@pytest.mark.parametrize("V", [65_536, 151_936, 50_257])
def test_fused_sample_ties_and_edges(cuda, V):
    """Greedy rows whose maximum sits at a range boundary: tied on both
    sides of every split edge (the lower index must win), at index 0, at
    the last index, tied at both ends; an all-NaN row and an all--inf row
    give index 0. Bit-exact against the plain version."""
    z, keys = _sample_case(cuda, 8, V, V, noisy=False)
    assert z.data_ptr() % 16 == 0
    e0, e1, e7 = (_split_edges(V, row) for row in (0, 1, 7))
    for e in e0:
        z[0, e - 1] = z[0, e] = 100.0        # tie across each edge
    z[1, e1[-1]] = z[1, e1[-1] + 1] = 100.0  # tie at the last edge
    z[2, 0] = 100.0
    z[3, V - 1] = 100.0
    z[4, 0] = z[4, V - 1] = 100.0
    z[5] = float("nan")
    z[6] = float("-inf")
    z[7, e7[0]] = 100.0                      # the first entry of range 1
    want = ops.sample_rows(z, keys, backend="ref")
    got = ops.sample_rows(z, keys)
    assert torch.equal(got, want)
    assert got.tolist() == [e0[0] - 1, e1[-1], 0, V - 1, 0, 0, 0, e7[0]]


def _scaled(cuda, shape, dtype, seed):
    """Rows of very different magnitudes, so every block has its own
    scale, plus one all-zero block (scale floor)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda)
    x = x * torch.exp(4 * torch.randn(shape[:-1] + (1,), generator=g,
                                      device=cuda))
    x.view(-1, shape[-1])[0, :128] = 0
    return x.to(dtype)


def _bits_equal(a, b):
    """Same dtype, shape and bytes (a NaN equals a NaN of the same bits)."""
    return CS.bits_equal(torch, a, b)


def _pack_all_ways(x, block, lo, rows):
    """Kernel against plain version: qdma_pack, qdma_pack_rows on rows
    [lo, lo + rows) of the row view, and qdma_unpack to fp32 and bf16.
    Returns the plain (q, scale)."""
    q, s = ops.qdma_pack(x, block=block)
    wq, ws = ops.qdma_pack(x, block=block, backend="ref")
    assert _bits_equal(q, wq) and _bits_equal(s, ws)
    rq, rs = ops.qdma_pack_rows(x, lo, rows=rows, block=block)
    L = x.shape[-1]
    assert _bits_equal(rq, wq.view(-1, L)[lo:lo + rows])
    assert _bits_equal(rs, ws.view(-1, L // block)[lo:lo + rows])
    for dtype in (torch.float32, torch.bfloat16):
        if block % 16 == 0:
            assert _bits_equal(
                ops.qdma_unpack(q, s, dtype=dtype),
                ops.qdma_unpack(q, s, dtype=dtype, backend="ref"))
    return wq, ws


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [128, 256])
def test_qdma_pack_unpack_bit_exact_on_card(cuda, dtype, block):
    """Blocks of very different magnitudes, and blocks whose quotients
    x / scale lie at n + 0.5 (exact ties), a few ulp either side and at
    +-127 (``chip_smoke.qdma_ties``): kernel and plain version bit for
    bit; the fp32 round trip within half a step of its block."""
    x = _scaled(cuda, (3, 37, 512), dtype, block)
    q, s = _pack_all_ways(x, block, 29, 50)
    _pack_all_ways(torch.from_numpy(CS.qdma_ties(block)).to(cuda).to(dtype),
                   block, 5, 300)
    got = ops.qdma_unpack(q, s, dtype=dtype)
    assert got.dtype == dtype
    if dtype == torch.float32:
        # |x - unpack(pack(x))| <= scale / 2, plus the roundings of x /
        # scale and q * scale (each at most 127 * scale * 2**-24)
        err = (got - x).view(3, 37, 512 // block, block).abs().amax(-1)
        assert bool((err <= s * (0.5 + 2 ** -16)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [128, 256])
def test_qdma_nan_inf_blocks_on_card(cuda, dtype, block):
    """Blocks holding a NaN, a +inf, a -inf, a NaN and an inf, and all
    zeros: scale NaN / inf / 1e-12 and q 0 throughout the first four, as
    in the JAX kernel; the unpack NaN across them (in bf16 XLA's 0x7FC0).
    Kernel and plain version bit for bit."""
    x = torch.from_numpy(CS.qdma_special(block)).to(cuda).to(dtype)
    q, s = _pack_all_ways(x, block, 1, 1)
    s = s.view(-1)
    assert bool(s[[0, 3]].isnan().all()) and bool((s[[1, 2]] == np.inf).all())
    assert float(s[4]) == float(np.float32(1e-12))
    assert not bool(q.view(6, block)[:4].any())
    u = ops.qdma_unpack(q, s.view(2, 3), dtype=torch.bfloat16)
    assert bool((u.view(6, block)[:4].view(torch.int16) == 0x7FC0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,block", [
    (torch.float32, 4), (torch.float32, 48), (torch.float32, 80),
    (torch.float32, 256), (torch.float32, 508), (torch.float32, 512),
    (torch.bfloat16, 8), (torch.bfloat16, 16), (torch.bfloat16, 24),
    (torch.bfloat16, 128), (torch.bfloat16, 1024)])
def test_qdma_pack_every_group_size_on_card(cuda, dtype, block):
    """Groups of 16 bytes to 2 KB, with 16-byte chunk counts that are and
    are not powers of two (a lane group of 1 to 32 lanes, one to four
    chunks a lane, or the two-pass kernel), an odd count of groups, and
    the unpack at blocks whose 16-byte pieces a block are not a power of
    two: kernel and plain version bit for bit."""
    x = _scaled(cuda, (7, 11, 3 * block), dtype, block)
    _pack_all_ways(x, block, 5, 61)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdma_many_steps_on_card(cuda, dtype):
    """More work than the card holds at once (every warp loops) and a
    ragged last step: 65,537 rows of 1,024 values at block 128, and an
    unpack of 349,525 blocks of 48 (its block index carried across
    pieces and steps)."""
    x = _scaled(cuda, (65_537, 1024), dtype, 7)
    _pack_all_ways(x, 128, 4_097, 60_000)
    q = torch.randint(-127, 128, (16_777_232 // 48, 48), device=cuda,
                      dtype=torch.int8)
    sc = torch.rand((q.shape[0], 1), device=cuda) + 0.5
    for out in (torch.float32, torch.bfloat16):
        assert _bits_equal(ops.qdma_unpack(q, sc, dtype=out),
                           ops.qdma_unpack(q, sc, dtype=out, backend="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bool", "int8", "int32", "bf16", "fp32",
                                  "odd_view"])
def test_qdma_digest_bit_exact_on_card(cuda, case):
    g = torch.Generator(device=cuda).manual_seed(3)
    n = 65_536 * 3 + 13                     # not a multiple of 16 or 64 Ki
    x = {"bool": lambda: torch.rand(n, generator=g, device=cuda) < 0.3,
         "int8": lambda: torch.randint(-128, 128, (n,), generator=g,
                                       device=cuda, dtype=torch.int8),
         "int32": lambda: torch.randint(-2**31, 2**31 - 1, (7, 1001),
                                        generator=g, device=cuda,
                                        dtype=torch.int32),
         "bf16": lambda: torch.randn((n,), generator=g,
                                     device=cuda).bfloat16(),
         "fp32": lambda: torch.randn((33, 4099), generator=g, device=cuda),
         "odd_view": lambda: torch.randint(0, 256, (n,), generator=g,
                                           device=cuda,
                                           dtype=torch.uint8)[3:]}[case]()
    got = ops.qdma_digest(x)
    assert torch.equal(got, ops.qdma_digest(x, backend="ref"))
    assert torch.equal(got, ops.qdma_digest(x))      # order-free atomics


@pytest.mark.cuda
def test_qdma_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.ones((4, 256), device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.qdma_pack(x, block=128)
    with pytest.raises(ValueError):
        ops.qdma_pack(torch.ones((4, 256), device=cuda), block=200)
    # groups the kernel cannot take (not 16-byte multiples, or more than a
    # warp's registers hold) are refused by the launcher itself
    before = dict(ops.LAUNCHES)
    for L, block in ((1000, 250), (1024, 1024)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            ops.qdma_pack(torch.ones((4, L), device=cuda), block=block)
    assert ops.LAUNCHES == before
    ops.qdma_digest(torch.ones(5, device=cuda))
    assert ops.LAUNCHES["qdma_digest"] == before["qdma_digest"] + 1


# ---------------------------------------------------------------------------
# training: no kernel under autograd; the eval step through the kernel
# ---------------------------------------------------------------------------
def _train_run(compute="bfloat16"):
    """qwen3-0.6b's smoke config with head_dim 64 (the attention kernel
    takes 64 or 128) and ``kernel_backend="auto"``."""
    import dataclasses
    from repro_torch.configs import PrecisionConfig, make_run_config
    run = make_run_config("qwen3-0.6b", "train_4k", smoke=True,
                          precision=PrecisionConfig(compute=compute))
    return run.replace(model=dataclasses.replace(run.model, head_dim=64))


def _train_batch(run, cuda, B=2, S=64):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, run.model.vocab_size, (B, S + 1))
    toks = torch.from_numpy(toks.astype(np.int32)).to(cuda)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.cuda
def test_kernels_refuse_inputs_that_require_grad(cuda):
    """A launch on inputs that require grad raises (the kernels have no
    backward), under no_grad it runs; the model's train-mode loss takes
    the plain versions, so its backward reaches every attention weight."""
    g = torch.Generator(device=cuda).manual_seed(9)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=cuda).to(
            dtype).requires_grad_(True)
    q, k, v = randn(1, 64, 16, 128), randn(1, 64, 8, 128), randn(1, 64, 8, 128)
    x, bv, cv = randn(1, 64, 4, 64), randn(1, 64, 64), randn(1, 64, 64)
    la = -randn(1, 64, 4, dtype=torch.float32).abs()
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssm_scan(x, bv, cv, la, chunk=64)
    assert ops.LAUNCHES == before
    with torch.no_grad():
        ops.flash_attention(q, k, v)
        ops.ssm_scan(x, bv, cv, la, chunk=64)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_map
    run = _train_run()
    params = tree_map(lambda t: t.requires_grad_(True),
                      build_model(run).init(seed=0, device=cuda))
    loss, _ = build_model(run).loss(params, _train_batch(run, cuda))
    loss.backward()
    for name in ("wq", "wk", "wv", "wo"):
        grad = params["decoder"]["layers"]["block0"][name].grad
        assert grad is not None and bool(grad.abs().sum() > 0), name


@pytest.mark.cuda
def test_eval_step_through_flash_attention_matches_plain_loss(cuda):
    """The eval step launches flash_attention once a layer and agrees with
    the train-mode loss through the plain attention: ce within 1e-2 (both
    sum the same bf16 stack; kernel and plain version round their fp32
    attention to bf16 after sums in other orders)."""
    from repro_torch.models.model import build_model
    from repro_torch.train.step import init_train_state, make_eval_step
    run = _train_run()
    params = init_train_state(run, seed=1, device=cuda)["params"]
    batch = _train_batch(run, cuda)
    before = ops.LAUNCHES["flash_attention"]
    ev = make_eval_step(run)(params, batch)
    assert ops.LAUNCHES["flash_attention"] - before == run.model.num_layers
    _, plain = build_model(run.replace(kernel_backend="reference")).loss(
        params, batch)
    assert abs(float(ev["ce"]) - float(plain["ce"])) <= 1e-2
    assert int(ev["ntok"]) == int(plain["ntok"])


def _sim_leaves(runner) -> dict:
    """(tid, path) -> host bytes of every running tenant's state leaf."""
    from repro_torch.tree import flatten
    out = {}
    for tid, tn in runner.tenants.items():
        if tn.status == "running":
            for path, x in flatten(tn.export_state())[0]:
                out[tid, path] = x.cpu().numpy().tobytes()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rates", [{}, {"serve_rate": 0.3, "crash_rate": 0.1}],
                         ids=["default", "serve_crash"])
def test_sim_scenario_on_card_matches_cpu(cuda, rates):
    """One seeded scenario with every tenant's state on the card: the same
    per-op outcomes, virtual time and final leaves, bit for bit, as the
    same scenario on the CPU (fp32 adds round alike on both)."""
    from repro_torch.sim import ScenarioConfig, ScenarioRunner
    from repro_torch.tree import tree_leaves
    cfg = ScenarioConfig(seed=3, policy="best_fit", num_ops=40, **rates)
    on_card = ScenarioRunner(cfg, device=cuda)
    got = on_card.run()
    on_cpu = ScenarioRunner(cfg, device="cpu")
    want = on_cpu.run()
    assert got.fingerprint() == want.fingerprint()
    assert got.virtual_seconds == want.virtual_seconds
    assert [r.status for r in got.ops] == [r.status for r in want.ops]
    leaves = _sim_leaves(on_card)
    assert leaves and leaves == _sim_leaves(on_cpu)
    assert all(x.device.type == "cuda" for tn in on_card.tenants.values()
               if tn.status == "running"
               for x in tree_leaves(tn.export_state()))


@pytest.mark.cuda
def test_serve_sim_tenant_live_pause_on_card(cuda):
    """``ServeSimTenant`` on the card through ``pause_vf_live`` (two
    pre-copy rounds while its cache steps) and ``unpause_vf``: params come
    back bit-equal, the cache at its step count, on the card."""
    from repro_torch.core import (DevicePool, StagingEngine, pause_vf_live,
                                  unpause_vf)
    from repro_torch.core.vf import VFState, VirtualFunction
    from repro_torch.sim import ServeSimTenant
    g = torch.Generator(device=cuda).manual_seed(5)
    params = {"w": torch.randn((512, 1024), generator=g, device=cuda),
              "b": torch.randn((1024,), generator=g,
                               device=cuda).bfloat16()}
    want = {k: v.clone() for k, v in params.items()}
    tn = ServeSimTenant(params, torch.zeros((64, 1024), device=cuda))
    pool = DevicePool(devices=("d0",))
    vf = VirtualFunction(vf_id="0000:0b:00.1")
    vf.assign_devices(pool.devices, (1, 1))
    vf.transition(VFState.ATTACHED)
    vf.owner = tn.tid
    tn.step()
    staging = StagingEngine(num_queues=4, incremental=True)
    snap, t = pause_vf_live(pool, vf, tn, staging, rounds=2, step_fn=tn.step)
    assert tn.params is None and t.stop_ms <= t.total * 1e3
    vf.assign_devices(pool.devices, (1, 1))
    unpause_vf(pool, vf, tn, snap, staging)
    assert tn.steps_done == 3 and tn.cache.device.type == "cuda"
    assert bool((tn.cache == 3.0).all())
    for k, v in want.items():
        assert tn.params[k].device.type == "cuda"
        assert CS.bits_equal(torch, tn.params[k], v), k


def _mig_run(arch):
    """``arch``'s smoke config with head_dim 64 (the attention kernel
    takes 64 or 128)."""
    import dataclasses
    from repro_torch.configs import make_run_config
    run = make_run_config(arch, "decode_32k", smoke=True)
    return run.replace(model=dataclasses.replace(run.model, head_dim=64))


def _mig_fleet(arch, cuda, params, run, tmp, **kw):
    from repro_torch.serve.fleet import ServeFleet
    return ServeFleet(run, params, num_engines=2, num_devices=4, slots=2,
                      max_len=64, page_size=8, device=cuda,
                      workdir=str(tmp), **kw)


def _mig_requests(n_tok, new=6):
    from repro_torch.serve.engine import Request
    return [Request(rid=i, prompt=(np.arange(n) * (i + 3) + 1) % 300,
                    max_new_tokens=new, temperature=0.8 if i % 2 else 0.0,
                    seed=3 + i) for i, n in enumerate(n_tok)]


def _chain_leaves(eng, rid):
    """(blk, name) -> the rid's chain of every paged leaf, and the slot's
    rows of every dense leaf, copied."""
    chain = eng.alloc.pages_of(rid)
    slot = next(s for s, r in enumerate(eng.active)
                if r is not None and r.rid == rid)
    out = {}
    for blk, node in eng._cache.items():
        for name, leaf in node.items():
            out[blk, name] = (leaf[:, chain] if name in
                              ("k", "v", "k_scale", "v_scale")
                              else leaf[:, slot]).clone()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["bf16", "int8"])
def test_migrated_request_pages_on_card(cuda, tmp_path, kv_dtype):
    """A request migrated mid-decode between two engines on the card (the
    smoke config with head_dim 64): with
    bf16 pages the target's chain is the source's, bit for bit; with int8
    pages the target's pages and scales are, bit for bit, the CPU port's
    plain requantization of the source's dequantized pages (what the JAX
    engine's jitted admission computes). The stream equals an undisturbed
    fleet's on the card."""
    from repro_torch.models.model import build_model
    run = _mig_run("qwen3-0.6b")
    params = build_model(run).init(seed=0, device=cuda)
    streams = []
    for migrate in (False, True):
        fleet = _mig_fleet("qwen3-0.6b", cuda, params, run,
                           tmp_path / str(migrate), kv_dtype=kv_dtype)
        reqs = _mig_requests((11, 7))
        for r in reqs:
            fleet.submit(r)
        for _ in range(2):
            fleet.step()
        if migrate:
            src = fleet.tenants["serve0"].engine
            dst = fleet.tenants["serve1"].engine
            before = _chain_leaves(src, 0)
            assert fleet.migrate_request("serve0", "serve1", 0) is not None
            after = _chain_leaves(dst, 0)
            for blk, name in before:
                if name.endswith("_scale"):
                    continue
                if kv_dtype is None:
                    assert CS.bits_equal(torch, after[blk, name],
                                         before[blk, name]), (blk, name)
                    continue
                q, s = (before[blk, name].cpu(),
                        before[blk, name + "_scale"].cpu())
                want_q, want_s = tref.kv_quant_ref(tref.kv_dequant_ref(q, s))
                assert torch.equal(after[blk, name].cpu(), want_q)
                assert CS.bits_equal(torch, after[blk, name + "_scale"].cpu(),
                                     want_s)
        fleet.drain()
        streams.append([list(r.out) for r in reqs])
    if kv_dtype is None:
        assert streams[0] == streams[1]


@pytest.mark.cuda
def test_hybrid_migration_on_card(cuda, tmp_path):
    """The hybrid twin at smoke width (head_dim 64) on the card: a request
    migrates mid-decode with its conv and SSM slot state (bit for bit) and
    its KV chain, and every stream equals an undisturbed fleet's on the
    card."""
    from repro_torch.models.model import build_model
    run = _mig_run("jamba-1.5-large-398b-1p-dense")
    params = build_model(run).init(seed=0, device=cuda)
    streams = []
    for migrate in (False, True):
        fleet = _mig_fleet(run.model.name, cuda, params, run,
                           tmp_path / str(migrate))
        reqs = _mig_requests((16, 9))
        for r in reqs:
            fleet.submit(r)
        for _ in range(2):
            fleet.step()
        if migrate:
            before = _chain_leaves(fleet.tenants["serve0"].engine, 0)
            assert fleet.migrate_request("serve0", "serve1", 0) is not None
            after = _chain_leaves(fleet.tenants["serve1"].engine, 0)
            assert any(name in ("conv", "ssm") for _, name in before)
            for key in before:
                assert CS.bits_equal(torch, after[key], before[key]), key
        fleet.drain()
        streams.append([list(r.out) for r in reqs])
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# the dense per-slot ring and the decode-roofline rows
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_dense_per_slot_decode_on_card_matches_cpu(cuda):
    """The dense ring's per-slot decode (the plain attention with per-slot
    KV lengths, in place) on the card against the same run on the CPU:
    slots of 5, 16 and 32 tokens, slot 1 inactive, three steps at fp32
    compute. Logits and the ring within 1e-4 (fp32 sums in other orders),
    slot 1's bytes untouched on the card. Then a smoke dense engine on
    the card at bf16 compute: fused sampling launches ``fused_sample``
    and gives the host sampler's tokens (I10)."""
    import dataclasses
    from repro_torch.configs import PrecisionConfig, make_run_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.tree import tree_to
    torch.backends.cuda.matmul.allow_tf32 = False
    run = make_run_config("qwen3-0.6b", "decode_32k", smoke=True,
                          precision=PrecisionConfig(compute="float32"))
    run = run.replace(model=dataclasses.replace(run.model, head_dim=64))
    model = build_model(run)
    params = model.compute_params(model.init(seed=0, device="cpu"))
    lens, T = (5, 16, 32), 48
    rng = np.random.default_rng(3)
    ring = model.init_cache(dataclasses.replace(run.shape, seq_len=T,
                                                global_batch=3),
                            device="cpu")
    for b, L in enumerate(lens):
        c, _ = model.prefill(params, {"tokens": torch.from_numpy(
            rng.integers(0, 500, (1, L)))})
        for blk, node in c.items():
            for name, leaf in node.items():
                ring[blk][name][:, b, :L] = leaf[:, 0]
    ring_c = tree_to(ring, cuda, copy=True)
    params_c = tree_to(params, cuda)
    before = {(blk, n): t[:, 1].clone() for blk, node in ring_c.items()
              for n, t in node.items()}
    active = torch.tensor([True, False, True])
    for step in range(3):
        pos = torch.tensor([lens[0] + step, -1, lens[2] + step],
                           dtype=torch.int32)
        toks = torch.from_numpy(rng.integers(0, 500, (3, 1)))
        want, ring = model.decode_step(params, ring, toks, pos,
                                       active=active)
        got, ring_c = model.decode_step(params_c, ring_c, toks.to(cuda),
                                        pos.to(cuda), active=active.to(cuda))
        torch.testing.assert_close(got.cpu()[active], want[active],
                                   atol=1e-4, rtol=1e-4)
    for blk, node in ring.items():
        for name, leaf in node.items():
            torch.testing.assert_close(ring_c[blk][name].cpu(), leaf,
                                       atol=1e-4, rtol=1e-4)
            assert torch.equal(ring_c[blk][name][:, 1],
                               before[blk, name]), (blk, name)

    # a smoke engine at bf16 compute (fp32 compute through the engines:
    # chip_smoke.py's run_fp32)
    brun = run.replace(precision=PrecisionConfig())
    bparams = build_model(brun).init(seed=0, device=cuda)

    def serve(fused):
        eng = ServeEngine(brun, bparams, device=cuda, slots=2, max_len=64,
                          fused_sampling=fused)
        reqs = [Request(rid=i, prompt=(np.arange(n) * (i + 3) + 1) % 300,
                        max_new_tokens=6, temperature=0.8 if i % 2 else 0.0,
                        seed=3 + i) for i, n in enumerate((5, 9, 3))]
        for r in reqs:
            eng.submit(r)
        assert eng.run_until_idle().drained and not eng.paged
        return [list(r.out) for r in reqs]
    host = serve(False)
    before = ops.LAUNCHES["fused_sample"]
    assert serve(True) == host
    assert ops.LAUNCHES["fused_sample"] > before


@pytest.mark.cuda
def test_decode_roofline_rows_on_card_within_the_data_sheet(cuda):
    """``bench.decode_roofline`` at its full shapes on the card, fp32 as
    the JAX rows, against the H100 data sheet (``Peaks()``): the five
    rows, each reading at most the sheet's bytes a second, and the int8
    pool's bytes at most 0.6x the fp32 pool's."""
    from repro_torch.bench import decode_roofline
    from repro_torch.runtime.roofline import Peaks
    before = dict(ops.LAUNCHES)
    rows, _ = decode_roofline.bench(reduced=False, reps=3, peaks=Peaks(),
                                    device=cuda, log=lambda *_: None)
    assert [r["name"] for r in rows[:-1]] == list(decode_roofline.ROWS)
    for r in rows[:-1]:
        assert r["wall_s"] > 0 and r["achieved_bw_frac"] <= 1.0, r
        assert r["peak_frac"] <= 1.0, r
    assert rows[-1]["int8_bytes_vs_fp"] <= 0.6
    for k in ("flash_decode", "paged_decode", "paged_decode_quant",
              "fused_sample", "ssm_scan"):
        assert ops.LAUNCHES[k] > before[k], k


# ---------------------------------------------------------------------------
# pipeline-parallel serving
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pipeline_gang_on_card_equals_single_stage(cuda, kv_dtype):
    """deepseek-67b's smoke config with 4 layers (head_dim 16) on the card,
    bf16: ``PipelineServeEngine`` at K = 1-4 and across a live reshape 4
    -> 2 gives the single-stage paged engine's streams bit for bit
    (greedy and sampled), launching the paged decode kernel; after
    ``drop_device_state`` no stage view holds the card's memory."""
    import dataclasses
    from repro_torch.configs import make_run_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.pipeline_engine import PipelineServeEngine
    run = make_run_config("deepseek-67b", "decode_32k", smoke=True)
    run = run.replace(model=dataclasses.replace(run.model, num_layers=4))
    params = build_model(run).init(seed=2, device=cuda)
    kernel = "paged_decode_quant" if kv_dtype else "paged_decode"

    def serve(eng, hook=None):
        reqs = [Request(rid=i, prompt=(np.arange(n) * (i + 3) + 1) % 500,
                        max_new_tokens=8, temperature=0.8 if i % 2 else 0.0,
                        top_k=16 if i % 4 == 1 else 0, seed=3 + i)
                for i, n in enumerate((5, 9, 3, 17, 12))]
        for r in reqs:
            eng.submit(r)
        steps = 0
        while (eng.step() or eng.queue) and steps < 200:
            steps += 1
            if hook is not None:
                hook(eng, steps)
        assert all(r.done for r in reqs)
        return [list(r.out) for r in reqs]

    kw = dict(device=cuda, slots=3, max_len=64, kv_dtype=kv_dtype)
    want = serve(ServeEngine(run, params, paged=True, **kw))
    for k in (1, 2, 3, 4):
        before = ops.LAUNCHES[kernel]
        assert serve(PipelineServeEngine(run, params, stages=k, **kw)) \
            == want, k
        assert ops.LAUNCHES[kernel] > before
    gang = PipelineServeEngine(run, params, stages=4, **kw)
    assert serve(gang, hook=lambda e, s: s == 4 and e.apply_reshape(2)) \
        == want
    assert gang.stage_width == 2 and gang.reshape_count == 1
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(cuda)
    gang.drop_device_state()
    torch.cuda.synchronize()
    assert gang._sparams is None
    assert m0 - torch.cuda.memory_allocated(cuda) > 0


@pytest.mark.cuda
def test_fed_scenario_and_fault_cells_on_card_match_cpu(cuda):
    """A federation scenario at the JAX fault-soup rates, and a cell of
    every network-fault window, with the sim tenants' state on the card:
    the same fingerprint, counters and per-op rows, the same outcome
    dicts, as on the CPU (the runner holds every running tenant's state
    leaves on the card after every op)."""
    from repro_torch.sim import (NETWORK_FAULTS, FedScenarioConfig,
                                 run_fed_scenario, run_network_fault_case)
    for policy in ("first_fit", "fair_share"):
        cfg = FedScenarioConfig(seed=2, policy=policy, **CS.FED_SOUP)
        assert run_fed_scenario(cfg, device=cuda) == \
            run_fed_scenario(cfg, device="cpu")
    for window in NETWORK_FAULTS:
        assert run_network_fault_case(window, 1, device=cuda) == \
            run_network_fault_case(window, 1, device="cpu")


@pytest.mark.cuda
def test_federation_engines_on_card_match_cpu(cuda, tmp_path):
    """Two hosts' smoke-width qwen3-0.6b engines (head_dim 64) on the card
    through ``chip_smoke.federation_engines``: 8 clean cross-host
    migrations, 3 mid-ship and 3 after-admit deferrals recovered. The
    migrations and both journals equal the same run's on the CPU, the
    streams an undisturbed engine's on the card, and the launches include
    ``flash_attention`` and ``paged_decode``."""
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.tree import tree_to
    run = _mig_run("qwen3-0.6b")
    params = build_model(run).init(seed=0, device=cuda)

    def reqs():
        return [Request(rid=i, prompt=(np.arange(5 + 3 * (i % 3)) * (i + 2)
                                       + 1) % 300, max_new_tokens=16,
                        temperature=0.8 if i % 2 else 0.0,
                        top_k=16 if i % 4 == 1 else 0, seed=3 + i)
                for i in range(10)]

    kw = dict(slots=4, max_len=64, page_size=8)
    ops.reset_launch_counts()
    got = CS.federation_engines(CS.port_federation_kit(cuda), run, params,
                                str(tmp_path / "card"), reqs(), **kw)
    counts = ops.launch_counts()
    assert counts["flash_attention"] > 0 and counts["paged_decode"] > 0
    want = CS.federation_engines(CS.port_federation_kit(
        torch.device("cpu")), run, tree_to(params, "cpu"),
        str(tmp_path / "cpu"), reqs(), **kw)
    assert [m["kind"] for m in got["migrations"]] == list(CS.FED_PLAN)
    assert ([(m["kind"], m["rid"], m["src"]) for m in got["migrations"]]
            == [(m["kind"], m["rid"], m["src"]) for m in want["migrations"]])
    assert got["journals"] == want["journals"]
    eng = ServeEngine(run, params, device=cuda, paged=True,
                      fused_sampling=True, **kw)
    plain = reqs()
    for r in plain:
        eng.submit(r)
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
    assert [list(r.out) for r in plain] == got["streams"]


@pytest.mark.cuda
def test_dryrun_decode_cell_against_the_card(cuda):
    """The dry-run's decode_32k cell at B = 8 (qwen3-0.6b at full width),
    counted on the unit mesh by ``run_cell`` with the kernel path, then
    run on the card: the step no faster than its bound, its peak memory
    at least the counted argument bytes, flash_decode on every layer."""
    import dataclasses
    import tempfile
    from repro_torch.configs import make_run_config
    from repro_torch.configs.base import SHAPES, UNIT_MESH
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.model import build_model
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=8)
    with tempfile.TemporaryDirectory() as out:
        cell = run_cell("qwen3-0.6b", "decode_32k", False, out_dir=out,
                        force=True, tag="b8", shape=shape, mesh=UNIT_MESH,
                        overrides={"kernel_backend": "auto"})
    assert cell["status"] == "ok", cell.get("error")
    run = make_run_config("qwen3-0.6b", shape)
    model = build_model(run)
    params = model.init(seed=0, device=cuda)
    cache = model.init_cache(device=cuda)
    tokens = torch.zeros((8, 1), dtype=torch.int32, device=cuda)
    with torch.no_grad():
        model.decode_step(params, cache, tokens, 32767)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, _ = model.decode_step(params, cache, tokens, 32767)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    assert bool(torch.isfinite(logits).all())
    assert ops.launch_counts()["flash_decode"] == 3 * run.model.num_layers
    assert cell["cost_extrapolated"]["kernels"] == {
        "flash_decode": run.model.num_layers}
    assert float(np.median(times)) >= cell["roofline"]["step_s"] * 1e3
    assert (torch.cuda.max_memory_allocated()
            >= cell["memory"]["argument_bytes"])


# ---------------------------------------------------------------------------
# fp32 inputs: the attention kernels' fp32 paths (flash_attention's on the
# tensor cores as 3xTF32 products, the decodes' on the CUDA cores), held to
# JAX's fp32 tolerance (tests/test_kernels.py: atol = rtol = 2e-5) against
# the plain version on the card (fp32 matmuls in full fp32)
# ---------------------------------------------------------------------------
FP32_TOL = 2e-5
#: flash_attention's 3xTF32 products hold a value to about 2^-22: the
#: largest share of the fp32 limit any output may use (0.03-0.06 emulated,
#: tests/test_torch_fp32.py)
FP32_ATTN_SHARE = 0.25


def _fp32_share(got, want):
    """The largest share of the fp32 limit 2e-5 + 2e-5 |want| any element
    of ``got`` uses."""
    lim = FP32_TOL + FP32_TOL * want.abs()
    return float(((got - want).abs() / lim).max())


@pytest.fixture
def full_fp32():
    """fp32 products in full fp32 (the plain versions' einsums)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    # JAX's sweep (tests/test_kernels.py:26-32)
    (1, 128, 128, 4, 4, 64, True),
    (2, 256, 256, 4, 2, 64, True),
    (1, 256, 256, 8, 1, 128, True),
    (2, 128, 128, 2, 2, 64, False),
    (1, 384, 384, 6, 3, 64, True),
    # qwen's prompts, phi3's hd 96, internvl2's and arctic's G 7, the
    # tiles' edges, T != S, the smallest hd
    (1, 384, 384, 16, 8, 128, True),
    (1, 600, 600, 16, 8, 128, True),
    (1, 384, 384, 32, 32, 96, True),
    (1, 640, 640, 14, 2, 64, True),
    (1, 200, 200, 56, 8, 128, True),
    (1, 65, 65, 8, 8, 32, True),
    (1, 1, 1, 16, 8, 128, True),
    (1, 100, 300, 16, 8, 128, False),
    (1, 300, 75, 16, 16, 64, False),
    (2, 63, 63, 4, 2, 8, True),
])
def test_flash_attention_fp32_on_card(cuda, full_fp32, B, S, T, H, K, hd,
                                      causal):
    """flash_attention on fp32 inputs launches its kernel and lies within
    JAX's fp32 tolerance of the plain version, using at most
    FP32_ATTN_SHARE of it; fp32 out, the same bits again."""
    q, k, v = _attn_inputs(cuda, S + T + H + hd, B, S, T, H, K, hd,
                           torch.float32)
    _check_fp32_attention(q, k, v, causal)


def _check_fp32_attention(q, k, v, causal):
    """One fp32 flash_attention launch within the fp32 limit, using at
    most FP32_ATTN_SHARE of it, and the same bits again; returns its
    output."""
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.float32
    want = ops.flash_attention(q, k, v, causal=causal, backend="ref")
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    share = _fp32_share(got, want)
    print(f"flash_attention fp32 q {tuple(q.shape)} k/v {tuple(k.shape)} "
          f"causal={causal}: {share:.4f} of the fp32 limit")
    assert share <= FP32_ATTN_SHARE
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))
    return got


def _tf32_ties(x):
    """x with the low 13 bits of each fp32 value set to 0x1000: its TF32
    rounding falls exactly at a tie (and its remainder lo is a power of
    two)."""
    bits = x.view(torch.int32)
    return ((bits & ~0x1FFF) | 0x1000).view(torch.float32)


def _attention_f64(q, k, v):
    """Causal GQA attention with every step in float64 (the exact answer
    the fp32 versions approximate), in fp32."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kk, vv = (x.double().repeat_interleave(G, 2) for x in (k, v))
    s = torch.einsum("bshd,bthd->bhst", q.double(), kk) / hd ** 0.5
    mask = torch.ones((S, k.shape[1]), dtype=torch.bool,
                      device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bhst,bthd->bshd", p, vv).float()


#: q alone scaled by 4 and by 16: the kernel's largest share of the fp32
#: limit around the float64 answer (the plain fp32 version itself uses
#: 0.22-0.32 of it at 4 and 1.1-1.7 at 16, emulated; tests/test_torch_fp32.py)
SHARP_SCORES_SHARE = {4.0: FP32_ATTN_SHARE, 16.0: 1.0}
#: the fp32 decodes' largest share of the fp32 limit: the paged ones under
#: fp32 q (three bf16 pieces of q and P over int8 pages, 3xTF32 over fp32
#: pages) at the serve engine's pool, flash_decode's 3xTF32 at qwen3-0.6b's
#: heads (0.009-0.027 emulated, tests/test_torch_fp32.py)
FP32_DECODE_SHARE = 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["scaled_16", "scaled_1_16", "q_4", "q_16",
                                  "near_equal", "tf32_ties"])
@pytest.mark.parametrize("S,H,K,hd", [(384, 16, 8, 128), (384, 32, 32, 96),
                                      (640, 14, 2, 64)],
                         ids=["qwen", "phi3", "internvl2"])
def test_flash_attention_fp32_split_on_card(cuda, full_fp32, case, S, H, K,
                                            hd):
    """The 3xTF32 split under stress, causal, at qwen's, phi3's and
    internvl2's prompts; each launch the same bits again. Scaled: q and v
    by f = 16 (1/16) and k by 1/f, so the operands' exponents move while
    the scores stay as at unit scale. Scaling by a power of two is exact,
    so the split must give f times the unit-scale output bit for bit,
    and that output is held to FP32_ATTN_SHARE of the limit. q_4, q_16: q
    alone scaled, so every score grows by 4 (16) and the softmax
    sharpens. The plain fp32 version then leaves the exact answer by up
    to 1.7 times the limit itself, so the kernel is held against the
    attention in float64: at most SHARP_SCORES_SHARE of the fp32 limit
    around it, and no farther from it than the plain fp32 version.
    Near-equal: every key one shared row plus noise of 1e-3, so each
    row's scores are near-equal and the outputs near zero. Ties: every
    value of q, k and v at a TF32 rounding tie. Both at most
    FP32_ATTN_SHARE."""
    q, k, v = _attn_inputs(cuda, S + H + hd, 1, S, S, H, K, hd,
                           torch.float32)
    if case in ("scaled_16", "scaled_1_16"):
        f = 16.0 if case == "scaled_16" else 1 / 16
        unit = _check_fp32_attention(q, k, v, True)
        got = ops.flash_attention(q * f, k / f, v * f)
        assert torch.equal(got, unit * f)
        return
    if case in ("q_4", "q_16"):
        f = float(case[2:])
        q = q * f
        got = ops.flash_attention(q, k, v)
        exact = _attention_f64(q, k, v)
        share = _fp32_share(got, exact)
        plain = _fp32_share(ops.flash_attention(q, k, v, backend="ref"),
                            exact)
        print(f"flash_attention fp32 q x{f:g} q {tuple(q.shape)} k/v "
              f"{tuple(k.shape)}: {share:.4f} of the fp32 limit around "
              f"float64, plain fp32 {plain:.4f}")
        assert share <= SHARP_SCORES_SHARE[f]
        assert share <= plain
        assert torch.equal(got, ops.flash_attention(q, k, v))
        return
    if case == "near_equal":
        k = (k[:, :1] + 1e-3 * k).contiguous()
    else:
        q, k, v = (_tf32_ties(x) for x in (q, k, v))
    _check_fp32_attention(q, k, v, True)


def _fp32_attention_rows(q, k, v, causal, rows):
    """The fp32 flash_attention kernel with its query rows a block forced
    (one of ops.FLASH_ATTENTION_FP32_ROWS; the wrapper lets the launcher
    choose)."""
    from repro_torch.kernels import build
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = build.library("flash_attention").launch_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        H, K, hd, int(causal), rows, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (1, 65, 65, 8, 8, 32, True),
    (2, 63, 63, 4, 2, 8, True),
    (1, 384, 384, 32, 32, 96, True),
    (1, 600, 600, 16, 8, 128, True),
    (1, 640, 640, 14, 2, 64, True),
    (1, 100, 300, 16, 8, 128, False),
    (1, 300, 75, 16, 16, 64, False),
])
def test_flash_attention_fp32_block_rows_on_card(cuda, full_fp32, B, S, T,
                                                 H, K, hd, causal):
    """The fp32 kernel's two grids, 32 query rows a block (two row warps x
    four key groups) and 64 (four x two), each forced: within the fp32
    limit, at most FP32_ATTN_SHARE of it, the same bits again; the
    wrapper's launch is one of the two."""
    q, k, v = _attn_inputs(cuda, S + T + H + hd + 1, B, S, T, H, K, hd,
                           torch.float32)
    want = ops.flash_attention(q, k, v, causal=causal, backend="ref")
    outs = {}
    for rows in ops.FLASH_ATTENTION_FP32_ROWS:
        got = _fp32_attention_rows(q, k, v, causal, rows)
        torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
        assert _fp32_share(got, want) <= FP32_ATTN_SHARE
        assert torch.equal(got, _fp32_attention_rows(q, k, v, causal, rows))
        outs[rows] = got
    auto = ops.flash_attention(q, k, v, causal=causal)
    assert any(torch.equal(auto, got) for got in outs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,K,hd,pos", [
    # JAX's sweep (tests/test_kernels.py:61-66)
    (1, 256, 4, 4, 64, 255),
    (2, 512, 4, 2, 64, 17),
    (1, 1024, 8, 2, 128, 700),
    (2, 256, 2, 1, 64, 0),
    # the generate path's and the serve shapes: qwen's G 2, G 8, 7, hd 96
    # and 256, the longest split
    (8, 1024, 16, 8, 128, 1023),
    (4, 1024, 64, 8, 128, 511),
    (2, 1024, 28, 4, 96, 1000),
    (2, 512, 8, 4, 256, 300),
    (1, 8192, 16, 8, 128, 8191),
])
def test_flash_decode_fp32_on_card(cuda, full_fp32, B, T, H, K, hd, pos):
    """flash_decode on fp32 inputs: within JAX's fp32 tolerance of the
    plain version for an int and a device-tensor position, at most
    FP32_DECODE_SHARE of it at qwen3-0.6b's heads (16/8 of 128), the same
    bits again, and NaN past pos changes nothing."""
    q, k, v = _attn_inputs(cuda, T + H + hd + pos, B, 1, T, H, K, hd,
                           torch.float32)
    want = ops.flash_decode(q, k, v, pos, backend="ref")
    before = ops.LAUNCHES["flash_decode"]
    got = ops.flash_decode(q, k, v, pos)
    assert ops.LAUNCHES["flash_decode"] == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    share = _fp32_share(got, want)
    print(f"flash_decode fp32 q ({B},1,{H},{hd}) k/v ({B},{T},{K},{hd}) pos "
          f"{pos}: {share:.4f} of the fp32 limit")
    if (H, K, hd) == (16, 8, 128):
        assert share <= FP32_DECODE_SHARE
    p = torch.tensor(pos, dtype=torch.int64, device=cuda)
    assert torch.equal(got, ops.flash_decode(q, k, v, p))
    k[:, pos + 1:] = float("nan")
    v[:, pos + 1:] = float("nan")
    assert torch.equal(got, ops.flash_decode(q, k, v, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,G,K,hd,page,NP,P,positions", [
    # JAX's sweep (tests/test_kernels.py:94-99)
    (1, 1, 4, 64, 16, 4, 8, (63,)),
    (3, 2, 2, 64, 8, 4, 16, (5, -1, 31)),
    (2, 4, 2, 128, 32, 2, 5, (0, 40)),
    (2, 2, 1, 64, 8, 8, 17, (-1, -1)),
    # the serve engine's pool: qwen's heads at the paged phase's positions
    (8, 2, 8, 128, 16, 64, 513, (1023, -1, 600, 15, 0, 384, 200, -1)),
    # G 8 and 7, hd 96, 256 and 32, pages of 1 and 128 rows
    (4, 8, 4, 128, 16, 64, 257, (1023, 600, 15, -1)),
    (4, 7, 2, 96, 16, 32, 129, (511, 200, 16, -1)),
    (2, 2, 4, 256, 16, 32, 65, (511, 129)),
    (2, 4, 4, 32, 1, 256, 513, (255, 0)),
    (2, 2, 4, 128, 128, 8, 17, (1023, 130)),
])
def test_paged_decode_fp32_on_card(cuda, full_fp32, quant, B, G, K, hd,
                                   page, NP, P, positions):
    """The paged kernels under fp32 q (fp32 pages, or int8 pages with their
    fp32 scales): within JAX's fp32 tolerance of the plain version, at
    most FP32_DECODE_SHARE of it at the serve engine's pool, inactive rows
    exactly zero, the same bits again."""
    args = _paged_args(cuda, quant, 31 + NP + G + hd, B, G, K, hd, page, NP,
                       positions, P, dtype=torch.float32)
    name = "paged_decode_quant" if quant else "paged_decode"
    fn = getattr(ops, name)
    before = ops.LAUNCHES[name]
    got = fn(*args)
    assert ops.LAUNCHES[name] == before + 1
    assert got.dtype == torch.float32
    want = fn(*args, backend="ref")
    torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    share = _fp32_share(got, want)
    print(f"{name} fp32 q {tuple(args[0].shape)} pages "
          f"{tuple(args[1].shape)} pos {positions}: {share:.4f} of the fp32 "
          "limit")
    if (B, NP, P) == (8, 64, 513):
        assert share <= FP32_DECODE_SHARE
    for b, p in enumerate(positions):
        if p < 0:
            assert torch.all(got[b] == 0)
    assert torch.equal(got, fn(*args))


#: outputs of the attention kernels, each as ``_digest`` gave it on the
#: card: case -> digest; the inputs come from numpy seeds
#: (``_pinned_output``). The paged decodes under fp32 q from the sources
#: of 21c0d31 (before their 3xTF32 tile moved into common.cuh, which fp32
#: flash_decode now shares); flash_decode_fp32 from its 3xTF32 kernel,
#: the one output that tile's move was meant to change; the others from
#: the sources of 56737b4 (before the TF32 helpers moved from
#: flash_attention.cu to common.cuh), unchanged since
PINNED_DIGESTS = {
    "flash_attention_fp32_qwen": "b746ed27514e3aa0",
    "flash_attention_fp32_phi3": "0beeaee6aafb96f6",
    "flash_attention_fp32_internvl2": "418c008f5920d15e",
    "flash_attention_bf16_qwen": "250ed769daf9a3d7",
    "flash_decode_bf16": "2803d8f5c3346511",
    "flash_decode_fp32": "c23de67204788371",
    "paged_decode_bf16": "fa716f6f537be8c2",
    "paged_decode_quant_bf16": "f438480551911db8",
    "paged_decode_fp32": "b4d63ccdfc161749",
    "paged_decode_quant_fp32": "9f892098f44adf98"}
PINNED_CASES = ("flash_attention_fp32_qwen", "flash_attention_fp32_phi3",
                "flash_attention_fp32_internvl2", "flash_attention_bf16_qwen",
                "flash_decode_bf16", "flash_decode_fp32",
                "paged_decode_bf16", "paged_decode_quant_bf16",
                "paged_decode_fp32", "paged_decode_quant_fp32")


def _digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:16]


def _pinned_output(cuda, case):
    """One launch of ``case``'s kernel on inputs from numpy seeds:
    flash_attention causal at qwen3-0.6b's S 384 (16/8 heads of 128),
    phi3-mini's hd 96 (32/32) and internvl2's S 640 (14/2 heads of 64);
    flash_decode at B 4, T 1,024, 16/8 heads of 128, pos 700; the paged
    decodes under bf16 and fp32 q (bf16, fp32 or int8 pages) at the serve
    engine's pool and positions."""
    if case.startswith("flash_attention"):
        who = case.rsplit("_", 1)[1]
        dt = torch.float32 if "fp32" in case else torch.bfloat16
        S, H, K, hd = {"qwen": (384, 16, 8, 128), "phi3": (384, 32, 32, 96),
                       "internvl2": (640, 14, 2, 64)}[who]
        q, k, v = _attn_inputs(cuda, S + H + hd, 1, S, S, H, K, hd, dt)
        return ops.flash_attention(q, k, v, causal=True)
    if case.startswith("flash_decode"):
        dt = torch.float32 if case.endswith("fp32") else torch.bfloat16
        q, k, v = _attn_inputs(cuda, 700, 4, 1, 1024, 16, 8, 128, dt)
        return ops.flash_decode(q, k, v, 700)
    name, kind = case.rsplit("_", 1)
    dt = torch.float32 if kind == "fp32" else torch.bfloat16
    args = _paged_args(cuda, name.endswith("quant"), 30, 8, 2, 8, 128, 16,
                       64, (1023, -1, 600, 15, 0, 384, 200, -1), 513,
                       dtype=dt)
    return getattr(ops, name)(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PINNED_CASES)
def test_attention_kernels_keep_their_bits_on_card(cuda, case):
    """fp32 flash_attention, its bf16 kernel, flash_decode (bf16 and fp32)
    and the paged decodes under bf16 and fp32 q give the bits pinned in
    PINNED_DIGESTS: moving the TF32 helpers into common.cuh, the fp32
    paged decodes' redesign and the move of their 3xTF32 tile into
    common.cuh for fp32 flash_decode's kernel changed no other kernel's
    arithmetic."""
    got = _pinned_output(cuda, case)
    assert _digest(got) == PINNED_DIGESTS[case]


@pytest.mark.cuda
def test_attention_kernels_refuse_mixed_and_fp16_on_card(cuda):
    """q, k and v all bf16 or all fp32: a mixed or an fp16 call raises
    TypeError before any launch (no fallback to the plain version)."""
    q, k, _ = _attn_inputs(cuda, 1, 1, 64, 64, 4, 2, 64, torch.float32)
    qd, kd, _ = _attn_inputs(cuda, 2, 2, 1, 256, 4, 2, 64, torch.float32)
    pq = qd
    pk = torch.ones((9, 16, 2, 64), device=cuda)
    t = torch.ones((2, 4), dtype=torch.int32, device=cuda)
    p = torch.tensor([10, 20], dtype=torch.int32, device=cuda)
    sc = torch.ones((9, 16, 2), device=cuda)
    i8 = torch.zeros((9, 16, 2, 64), dtype=torch.int8, device=cuda)
    calls = [
        lambda: ops.flash_attention(q, k.bfloat16(), k.bfloat16()),
        lambda: ops.flash_attention(q.half(), k.half(), k.half()),
        lambda: ops.flash_decode(qd.bfloat16(), kd, kd, 5),
        lambda: ops.flash_decode(qd.half(), kd.half(), kd.half(), 5),
        lambda: ops.paged_decode(pq, pk.bfloat16(), pk.bfloat16(), t, p),
        lambda: ops.paged_decode(pq.half(), pk.half(), pk.half(), t, p),
        lambda: ops.paged_decode_quant(pq.half(), i8, i8, sc, sc, t, p),
    ]
    before = dict(ops.LAUNCHES)
    for call in calls:
        with pytest.raises(TypeError):
            call()
    assert ops.LAUNCHES == before
