"""Attention: GQA reference implementation + kernel dispatch (mirrors
``repro.models.attention``).

``attention``, ``decode_attention`` and ``paged_decode_attention`` go
through ``repro_torch.kernels.ops``: the CUDA kernels for CUDA tensors,
their plain versions for CPU tensors or with ``backend="ref"``. They
follow the Pallas kernels' numerics (fp32 probabilities into the PV
product). ``attention_ref`` is the JAX package's model-level reference,
which casts the probabilities to v's dtype before PV. ``attention``
follows the JAX dispatch rule: only an int ``q_offset == 0`` with no
``kv_len`` takes ``flash_attention``; a query offset (a chunk of a
chunked prefill, whose K is the whole staging cache) or a KV length takes
``attention_ref``, as JAX computes it outside any Pallas kernel. The
engine passes a chunk's offset as a 0-d tensor, so even the first chunk
(offset 0, K longer than the chunk) takes the plain path, as JAX's traced
``jnp.int32`` offset does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool, q_offset=0, kv_len=None):
    """q: (B,Sq,H,hd); k,v: (B,T,K,hd). GQA-aware, fp32 softmax, causal
    mask top-left aligned (query i sees keys j <= i + q_offset).

    q_offset: absolute position of q[0] (an int or a 0-d tensor: chunked
    prefill). kv_len: optional valid KV length (an int, a 0-d tensor or a
    (B,) tensor) — masks t >= kv_len."""
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    t_pos = torch.arange(T, device=q.device)
    if causal:
        s_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        logits = logits.masked_fill(~(t_pos[None, :] <= s_pos), NEG_INF)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        if kv_len.dim() == 0:
            lm = (t_pos < kv_len)[None, None, None, None, :]
        else:                                          # per batch row (B,)
            lm = (t_pos[None, :] < kv_len[:, None])[:, None, None, None, :]
        logits = logits.masked_fill(~lm, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, hd)


def attention(q, k, v, *, causal: bool, backend: str = "auto", q_offset=0,
              kv_len=None):
    # only a static 0 offset may take the kernel (a 0-d tensor offset,
    # even one holding 0, is a chunk of a chunked prefill whose K is
    # longer than its q), as in the JAX dispatch
    if kv_len is None and isinstance(q_offset, int) and q_offset == 0:
        return kops.flash_attention(q, k, v, causal=causal, backend=backend)
    return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)


def decode_attention(q, k_cache, v_cache, pos, *, backend: str = "auto"):
    """Single-token decode over a dense cache. q: (B,1,H,hd); caches:
    (B,T,K,hd); pos: the index the current token was just written to
    (attend to <= pos). One position for the whole batch (an int or a 0-d
    tensor) takes ``flash_decode``. Per-slot positions, a (B,) tensor
    (the dense ring of continuous batching; pos[b] < 0 marks an inactive
    slot, whose output is meaningless and discarded), take
    ``attention_ref`` with ``kv_len = pos + 1``, as the JAX package
    computes them outside any Pallas kernel."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        return attention_ref(q, k_cache, v_cache, causal=False,
                             kv_len=pos.to(q.device) + 1)
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
