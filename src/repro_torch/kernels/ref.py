"""Plain PyTorch versions of the port's kernels (mirrors
``repro.kernels.ref``).

Each function here is the ground truth its CUDA kernel in ``csrc/`` is
held against, and what ``kernels.ops`` runs for a CPU tensor or with
``backend="ref"``. They follow the Pallas kernels' numerics: fp32 logits,
fp32 probabilities into the PV product, and an output cast to q's dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.sampling import torch_gumbel


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
def flash_attention_ref(q, k, v, causal: bool = True):
    """q: (B,S,H,hd); k,v: (B,T,K,hd) with H % K == 0. fp32 softmax.

    Causal masking is top-left aligned (query i sees keys j <= i), as in
    the Pallas kernel and the CUDA kernel. ``repro.kernels.ref`` aligns it
    bottom-right (``tril(k=T-S)``); the two agree for S == T, which is
    the only causal shape the serve path makes (whole-prompt prefill)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    if causal:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.to(torch.float32))
    return o.reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# flash_decode (single-token decode over a dense cache, uniform position)
# ---------------------------------------------------------------------------
def flash_decode_ref(q, k, v, pos):
    """q: (B,1,H,hd); k,v: (B,T,K,hd); pos: scalar (int or 0-d tensor) —
    attend to indices <= pos. fp32 softmax, GQA, output in q's dtype."""
    B, _, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    logits = torch.einsum("bkgh,btkh->bkgt", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    valid = torch.arange(T, device=q.device) <= torch.as_tensor(
        pos, device=q.device)
    logits = logits.masked_fill(~valid, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", p, v.to(torch.float32))
    return o.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# paged_decode (single-token decode over a block-table-indirected page pool)
# ---------------------------------------------------------------------------
def paged_decode_ref(q, k_pages, v_pages, tables, pos):
    """q: (B,1,H,hd); k_pages/v_pages: (P,page,K,hd) — the shared page pool;
    tables: (B,NP) int32 page ids forming each sequence's logical
    (NP*page)-token view; pos: (B,) int32 — last valid logical index per
    sequence (attend to <= pos; pos < 0 means no valid tokens and the
    output row is exactly zero, matching the kernel's zero-init
    accumulator when every page is skipped)."""
    B, _, H, hd = q.shape
    page, K = k_pages.shape[1], k_pages.shape[2]
    T = tables.shape[1] * page
    G = H // K
    tbl = tables.to(torch.int64)
    k = k_pages[tbl].reshape(B, T, K, hd)
    v = v_pages[tbl].reshape(B, T, K, hd)
    qg = q.reshape(B, K, G, hd)
    logits = torch.einsum("bkgh,btkh->bkgt", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    valid = (torch.arange(T, device=q.device)[None, :]
             <= pos.to(torch.int64)[:, None])[:, None, None, :]
    logits = logits.masked_fill(~valid, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), torch.zeros_like(logits))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgt,btkh->bkgh", p / denom, v.to(torch.float32))
    return o.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# int8 paged KV (per-row/head symmetric scales — see serve/paged.py)
# ---------------------------------------------------------------------------
def kv_quant_ref(x):
    """Symmetric int8 quantization of a KV tensor over its last (hd) axis.
    x: (..., hd) float -> (q int8 same shape, scale fp32 shape[:-1]).
    scale = max(max|x| * INV127, 1e-12) per (page-row, head) and q =
    round(x / scale), half to even. The JAX engine quantizes inside
    ``jit`` (its decode step and its admission scatter), where XLA turns
    ``max|x| / 127.0`` into a multiply by float32(1/127): the port
    multiplies by the same constant, on the host and on the card, so its
    scales are the JAX engine's bit for bit. A dequant -> requant round
    trip can move a scale by one ulp under this rule (the reference
    engine's too), so migrated int8 pages are the requantized bytes, not
    the source's."""
    xf = x.to(torch.float32)
    scale = (xf.abs().amax(dim=-1) * INV127).clamp_min(1e-12)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def kv_dequant_ref(q, scale, dtype=torch.float32):
    """Inverse of kv_quant_ref: (..., hd) int8 x (...) fp32 -> float."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def paged_decode_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                           tables, pos):
    """paged_decode_ref over an int8 page pool: k/v_pages (P,page,K,hd)
    int8 with per-(row,head) scales (P,page,K) fp32, dequantized before
    the fp32 attention math."""
    k = kv_dequant_ref(k_pages, k_scale)
    v = kv_dequant_ref(v_pages, v_scale)
    return paged_decode_ref(q, k, v, tables, pos)


# ---------------------------------------------------------------------------
# ssm_scan (chunked Mamba-2 SSD scan, scalar decay per head)
# ---------------------------------------------------------------------------
def ssm_scan_ref(xdt, Bv, Cv, log_a, chunk: int = 128):
    """What the Pallas kernel computes, in fp32 throughout, the state
    carried chunk to chunk. Per chunk of Q = min(chunk, S) tokens:

      cum   = cumsum(log_a)                                  (Q,)
      y     = ((exp(cum_t - cum_s) * tril) * (C B^T)) @ xdt
              + exp(cum) * (C H_prev^T)
      H_new = exp(cum_Q) H_prev + (exp(cum_Q - cum) * xdt)^T B

    xdt (B,S,H,hd), Bv/Cv (B,S,N), log_a (B,S,H). Returns y (B,S,H,hd)
    fp32 and the final state (B,H,hd,N) fp32. Unlike the JAX package's
    ``ssd_chunked``, nothing is rounded to the inputs' dtype."""
    B, S, H, hd = xdt.shape
    N = Bv.shape[-1]
    from repro_torch.kernels.ops import check_ssm_chunk  # ops imports ref
    Q = check_ssm_chunk(S, chunk)
    f32 = torch.float32
    x, Bf, Cf, la = (t.to(f32) for t in (xdt, Bv, Cv, log_a))
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((B, H, hd, N), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        xc, bc, cc = x[:, c0:c0 + Q], Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]
        cum = la[:, c0:c0 + Q].cumsum(dim=1)                      # (B,Q,H)
        M = cum[:, :, None] - cum[:, None, :]                     # (B,t,s,H)
        M = torch.where(tril[None, :, :, None], torch.exp(M),
                        torch.zeros((), dtype=f32, device=x.device))
        GB = torch.einsum("btn,bsn->bts", cc, bc)
        y = torch.einsum("btsh,bshd->bthd", M * GB[..., None], xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum("btn,bhdn->bthd",
                                                          cc, h)
        w = torch.exp(cum[:, -1:] - cum)                          # (B,Q,H)
        h = (torch.exp(cum[:, -1])[..., None, None] * h
             + torch.einsum("bshd,bsn->bhdn", w[..., None] * xc, bc))
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssm_scan_sequential_ref(xdt, Bv, Cv, log_a):
    """O(S) sequential oracle (slow, exact): H_t = a_t H_{t-1} + x_t B_t^T,
    y_t = H_t C_t, in fp32."""
    B, S, H, hd = xdt.shape
    f32 = torch.float32
    h = torch.zeros((B, H, hd, Bv.shape[-1]), dtype=f32, device=xdt.device)
    ys = []
    for t in range(S):
        a = torch.exp(log_a[:, t].to(f32))
        h = a[..., None, None] * h + torch.einsum(
            "bhd,bn->bhdn", xdt[:, t].to(f32), Bv[:, t].to(f32))
        ys.append(torch.einsum("bhdn,bn->bhd", h, Cv[:, t].to(f32)))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# fused_sample (temperature/top-k Gumbel sampling)
# ---------------------------------------------------------------------------
def sample_rows_ref(z, keys4):
    """The part of fused_sample the kernel computes: z (B,Vp) float32 from
    ``prepare_rows``; keys4 (B,4) int32 (seed, rid, counter, noisy).
    Returns (B,) int32 first-index argmax of z + noise (noisy rows) or z
    (greedy rows). The whole plain sampler is ``ops.fused_sample(...,
    backend="ref")``: ``prepare_rows``, then this."""
    idx = torch.arange(z.shape[1], device=z.device, dtype=torch.int64)
    g = torch_gumbel(keys4, idx)
    y = torch.where(keys4[:, 3:4] != 0, z + g, z)
    return torch.argmax(y, dim=-1).to(torch.int32)



# ---------------------------------------------------------------------------
# qdma_pack / qdma_unpack / qdma_digest (the staging engine's kernels)
# ---------------------------------------------------------------------------
#: float32(1/127). XLA on the CPU compiles the JAX kernels' ``max|x| /
#: 127.0`` into a multiply by this reciprocal (a division by a constant
#: becomes a multiply), which can differ from a true division in the last
#: bit; the plain version and the CUDA kernel multiply by it too, so all
#: three agree bit for bit. ``x / scale`` stays a true division there.
INV127 = float(np.float32(1.0) / np.float32(127.0))


def qdma_pack_ref(x, block: int = 256):
    """Blockwise symmetric int8 quantization over the last dim.
    Returns (q int8 same shape, scale fp32 shape[:-1]+(L/block,)), with
    ``scale = max(max|x| * INV127, 1e-12)`` per block and
    ``q = clip(round_half_even(x / scale), -127, 127)``. As in the JAX
    kernel, a NaN in a block makes its scale NaN and an inf makes it inf;
    either way ``x / scale`` is 0 or NaN there, and NaN converts to q 0
    (explicitly: torch leaves a NaN's conversion to int8 to the device)."""
    L = x.shape[-1]
    if L % block:
        raise ValueError(f"last dim {L} is not a multiple of block {block}")
    xb = x.to(torch.float32).reshape(x.shape[:-1] + (L // block, block))
    inv = torch.tensor(INV127, dtype=torch.float32, device=x.device)
    scale = (xb.abs().amax(dim=-1) * inv).clamp_min(1e-12)
    q = torch.round(xb / scale[..., None]).clamp(-127, 127).nan_to_num(0.0)
    return q.to(torch.int8).reshape(x.shape), scale


#: XLA's bfloat16 NaN bits, sign clear (0x7FC0) and set (0xFFC0) as int16
_BF16_NAN, _BF16_NEG_NAN = 0x7FC0, 0xFFC0 - 0x10000


def qdma_unpack_ref(q, scale, dtype=torch.float32):
    """Inverse of qdma_pack_ref: ``q * scale`` per block, cast to dtype.
    A NaN cast to bfloat16 becomes 0x7FC0 with its sign bit, as XLA casts
    it (torch's own cast gives other NaN bits, and not the same on the CPU
    and on the card)."""
    block = q.shape[-1] // scale.shape[-1]
    qb = q.reshape(q.shape[:-1] + (scale.shape[-1], block))
    x = (qb.to(torch.float32) * scale[..., None]).reshape(q.shape)
    y = x.to(dtype)
    if dtype == torch.bfloat16:
        nan = torch.where(torch.signbit(x), _BF16_NEG_NAN,
                          _BF16_NAN).to(torch.int16)
        y = torch.where(torch.isnan(x), nan, y.view(torch.int16)).view(dtype)
    return y


def row_view(x):
    """The (rows, L) view of x over its last dim (scalars: (1, 1))."""
    return x.reshape(-1, x.shape[-1]) if x.dim() else x.reshape(1, 1)


def qdma_pack_rows_ref(x, lo: int, rows: int, block: int = 256):
    """Pack rows [lo, lo+rows) of the 2-D row view of x (one descriptor)."""
    return qdma_pack_ref(row_view(x)[lo:lo + rows], block=block)


def bytes_view(x):
    """Raw little-endian bytes of x as a flat uint8 tensor (bool as 0/1)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


_MASK32 = 0xFFFFFFFF
#: (multiplier, offset) of the digest's two position weights
DIGEST_WEIGHTS = ((2654435761, 0x9E3779B1), (0x85EBCA6B, 0xC2B2AE35))
_DIGEST_CHUNK = 1 << 22


def _mul32(i, c: int):
    """(i * c) mod 2**32 for int64 i in [0, 2**32): split i in 16-bit
    halves so no product leaves int64."""
    lo, hi = i & 0xFFFF, i >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def qdma_digest_ref(x):
    """Position-weighted 2x32-bit fingerprint of x's raw bytes u:
    ``sum u[i] * (i * m + a) mod 2**32`` for the two (m, a) of
    ``DIGEST_WEIGHTS``, the byte index i taken mod 2**32. Returns (2,)
    int64 holding the two uint32 words.

    Torch has no wrapping uint32 product, so the words are carried in
    int64 and masked; the bytes go in chunks of 4 Mi, so the int64
    temporaries stay at 32 MiB whatever the leaf's size (a chunk's sum
    stays below 2**62)."""
    u8 = bytes_view(x)
    out = torch.zeros((2,), dtype=torch.int64, device=u8.device)
    for s in range(0, u8.numel(), _DIGEST_CHUNK):
        v = u8[s:s + _DIGEST_CHUNK].to(torch.int64)
        i = torch.arange(s, s + v.numel(), dtype=torch.int64,
                         device=v.device) & _MASK32
        for j, (m, a) in enumerate(DIGEST_WEIGHTS):
            w = (_mul32(i, m) + a) & _MASK32
            out[j] = (out[j] + (v * w).sum()) & _MASK32
    return out
