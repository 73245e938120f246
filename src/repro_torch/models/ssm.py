"""Mamba block — Mamba-2 (SSD) scalar-per-head-decay formulation (mirrors
``repro.models.ssm``):

  H_t = a_t * H_{t-1} + (dt_t x_t) ⊗ B_t        a_t = exp(dt_t * A_h) <= 1
  y_t = H_t · C_t + D_h x_t

Prefill and the full-sequence forward run the chunked scan through
``kernels.ops.ssm_scan`` (``kernels/csrc/ssm_scan.cu`` on the card, its
plain fp32 version on the CPU). Decode is the single-token state update
in plain torch, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import causal_conv1d, rms_norm
from repro_torch.models.params import mamba_dims


def _split_proj(cfg: ModelConfig, proj):
    d_inner, n_heads, _, _ = mamba_dims(cfg)
    N = cfg.ssm.d_state
    idx = [d_inner, 2 * d_inner, 2 * d_inner + N, 2 * d_inner + 2 * N]
    x = proj[..., :idx[0]]
    z = proj[..., idx[0]:idx[1]]
    Bv = proj[..., idx[1]:idx[2]]
    Cv = proj[..., idx[2]:idx[3]]
    dt = proj[..., idx[3]:]
    return x, z, Bv, Cv, dt


def mamba_block(cfg: ModelConfig, p: dict, x, cdt, mode: str = "train",
                cache: dict | None = None, backend: str = "auto"):
    """Full mamba mixer. x: (B,S,D). Returns (y, new_cache): in prefill
    and decode the new conv tail (B, conv-1, ch) in ``cdt`` and SSM state
    (B, heads, hd, N) fp32; None in train mode. Decode reads the old
    state from ``cache``; its caller writes the new one in place."""
    f32 = torch.float32
    d_inner, n_heads, _, _ = mamba_dims(cfg)
    N = cfg.ssm.d_state
    B_, S, D = x.shape

    h = rms_norm(x, p["ln"], cfg.norm_eps).to(cdt)
    proj = h @ p["in_proj"].to(cdt)                           # (B,S,dproj)
    xs, z, Bv, Cv, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xs, Bv, Cv], dim=-1)                 # (B,S,ch)
    conv_state = cache.get("conv") if cache else None
    conv_out, new_conv = causal_conv1d(conv_in, p["conv_w"], p["conv_b"],
                                       conv_state)
    conv_out = F.silu(conv_out.to(f32)).to(cdt)
    xs = conv_out[..., :d_inner]
    Bv = conv_out[..., d_inner:d_inner + N].contiguous()
    Cv = conv_out[..., d_inner + N:].contiguous()

    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))        # (B,S,H)
    A = -torch.exp(p["A_log"].to(f32))                        # (H,) < 0
    log_a = dt * A                                            # (B,S,H)
    xh = xs.reshape(B_, S, n_heads, -1)
    xdt = (xh.to(f32) * dt[..., None]).to(cdt)

    if mode == "decode":
        # single-token state update
        h0 = cache["ssm"].to(f32)                             # (B,H,hd,N)
        a = torch.exp(log_a[:, 0])                            # (B,H)
        upd = torch.einsum("bhd,bn->bhdn", xdt[:, 0].to(f32),
                           Bv[:, 0].to(f32))
        new_state = a[..., None, None] * h0 + upd
        y = torch.einsum("bhdn,bn->bhd", new_state,
                         Cv[:, 0].to(f32))[:, None]           # (B,1,H,hd)
    else:
        y, new_state = kops.ssm_scan(xdt, Bv, Cv, log_a, chunk=cfg.ssm.chunk,
                                     backend=backend)

    y = y + p["D"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(B_, S, d_inner)
    y = y * F.silu(z.to(f32))                                 # gate
    y = rms_norm(y.to(cdt), p["norm"], cfg.norm_eps)
    out = y.to(cdt) @ p["out_proj"].to(cdt)

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"conv": new_conv.to(cdt), "ssm": new_state.to(f32)}
    return out, new_cache
