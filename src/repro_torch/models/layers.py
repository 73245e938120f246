"""Shared primitive layers (plain functions on tensors, explicit params);
mirrors ``repro.models.layers``."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """numpy float32, the same computation as the JAX package, so the
    inverse frequencies match bit for bit."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` on ``device``, copied there once: a copy from
    pageable host memory waits for the device's queue to drain, which
    per layer call would serialise the host with the card."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding, split-half (llama) convention.

    x: (B, S, H, hd); positions: (S,) or (B, S) int.
    """
    hd = x.shape[-1]
    inv = _inv_freq(hd, float(theta), x.device)
    ang = positions.to(torch.float32)[..., None] * inv       # (..., S, hd/2)
    if ang.dim() == 2:                                        # (S, hd/2)
        ang = ang[None]                                       # (1, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]                       # (B|1,S,1,hd/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, wi, wg, wo, cdt):
    x = x.to(cdt)
    h = F.silu(x @ wg.to(cdt)) * (x @ wi.to(cdt))
    return h @ wo.to(cdt)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, cdt):
    from repro_torch.runtime.partitioning import is_dtensor
    if is_dtensor(table):
        # the vocab-split table gathered first (its gradient goes back
        # split): a lookup into split rows leaves a masked partial sum
        # whose backward DTensor cannot redistribute, and an index's
        # backward (an index_put) has no rule torch 2.11 can follow
        from torch.distributed.tensor import Replicate
        table = table.redistribute(table.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in table.placements])
        return F.embedding(tokens.to(torch.int64), table).to(cdt)
    return table[tokens.to(torch.int64)].to(cdt)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv over time. x: (B, S, C); w: (W, C); b: (C,),
    both read in fp32 whatever their storage dtype.

    If ``state`` is given — (B, W-1, C), the tail of the previous segment —
    it is prepended (decode), and the new tail returned. The taps are
    summed in the JAX package's order, into an fp32 accumulator."""
    B, S, C = x.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)            # (B, S+W-1, C)
    w32 = w.to(torch.float32)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(W):                                        # W is tiny (4)
        out = out + xp[:, i:i + S].to(torch.float32) * w32[i]
    out = out + b.to(torch.float32)
    new_state = xp[:, S:] if W > 1 else state
    return out.to(x.dtype), new_state
