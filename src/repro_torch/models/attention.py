"""Attention: GQA reference implementation + kernel dispatch (mirrors
``repro.models.attention``).

``attention``, ``decode_attention`` and ``paged_decode_attention`` go
through ``repro_torch.kernels.ops``: the CUDA kernels for CUDA tensors,
their plain versions for CPU tensors or with ``backend="ref"``. They
follow the Pallas kernels' numerics (fp32 probabilities into the PV
product). ``attention_ref`` is the JAX package's model-level reference,
which casts the probabilities to v's dtype before PV; nothing on the
serve path calls it. A query offset or a KV length (chunked prefill, the
per-slot dense ring) is not ported yet and is refused rather than run on
plain torch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool):
    """q: (B,Sq,H,hd); k,v: (B,T,K,hd). GQA-aware, fp32 softmax, causal
    mask top-left aligned (query i sees keys j <= i)."""
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    if causal:
        s_pos = torch.arange(Sq, device=q.device)[:, None]
        t_pos = torch.arange(T, device=q.device)[None, :]
        logits = logits.masked_fill(~(t_pos <= s_pos), NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, hd)


def attention(q, k, v, *, causal: bool, backend: str = "auto", q_offset=0,
              kv_len=None):
    if kv_len is not None or not (isinstance(q_offset, int)
                                  and q_offset == 0):
        raise NotImplementedError(
            "attention with a query offset or a KV length (chunked prefill, "
            "dense decode) is not ported yet (ROADMAP: deferred serve-engine "
            "parts)")
    return kops.flash_attention(q, k, v, causal=causal, backend=backend)


def decode_attention(q, k_cache, v_cache, pos, *, backend: str = "auto"):
    """Single-token decode over a dense cache. q: (B,1,H,hd); caches:
    (B,T,K,hd); pos: one position for the whole batch (an int or a 0-d
    tensor), the index the current token was just written to (attend to
    <= pos). Per-slot positions (the dense ring) are not ported yet:
    ``Model.decode_step`` refuses them."""
    return kops.flash_decode(q, k_cache, v_cache, pos, backend=backend)


def paged_decode_attention(q, k_pages, v_pages, tables, pos, *,
                           k_scale=None, v_scale=None,
                           backend: str = "auto"):
    """Single-token decode over the paged KV pool. q: (B,1,H,hd);
    k_pages/v_pages: (P,page,K,hd); tables: (B,NP) int32 page ids; pos:
    (B,) int32 last valid logical index (attend <= pos; < 0 = inactive
    slot, output row exactly zero). With ``k_scale``/``v_scale``
    ((P,page,K) fp32) the pools are int8 and the quantized kernel
    dequantizes in-tile."""
    if k_scale is not None:
        return kops.paged_decode_quant(q, k_pages, v_pages, k_scale,
                                       v_scale, tables, pos, backend=backend)
    return kops.paged_decode(q, k_pages, v_pages, tables, pos,
                             backend=backend)
