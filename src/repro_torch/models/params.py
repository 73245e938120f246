"""Parameter trees of the port (mirrors ``repro.models.params`` for the
attention and mamba blocks).

``param_shapes(cfg)`` builds the tree of ``ShapeDtype`` leaves,
``init_params`` materializes it on a device from a seed, and
``count_params_config`` folds it. Leaf names, shapes and the
period-stacked leading ``(num_periods,)`` axis are the JAX package's, so
``repro_torch.interop`` converts either way leaf for leaf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, MAMBA, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.tree import tree_items, tree_leaves, tree_map

VOCAB_PAD = 128  # pad vocab so TP over the model axis always divides


class ShapeDtype(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def _sd(shape, dtype) -> ShapeDtype:
    return ShapeDtype(tuple(int(s) for s in shape), dtype)


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm.head_dim
    # in_proj emits [x (d_inner), z (d_inner), B (d_state), C (d_state),
    #                dt (n_heads)]
    d_in_proj = 2 * d_inner + 2 * cfg.ssm.d_state + n_heads
    d_conv_ch = d_inner + 2 * cfg.ssm.d_state   # conv over x, B, C
    return d_inner, n_heads, d_in_proj, d_conv_ch


def ffn_shapes(cfg: ModelConfig, layer_idx: int, dtype) -> dict:
    """FFN half of a block (dense SwiGLU only in this slice)."""
    if cfg.layer_has_moe(layer_idx):
        raise NotImplementedError(
            f"{cfg.name}: MoE FFN is not ported yet (ROADMAP Queue 1 "
            "item 7, other model families)")
    D = cfg.d_model
    p = {}
    if cfg.d_ff > 0:
        F = cfg.d_ff
        p["ln2"] = _sd((D,), dtype)
        p["ffn"] = {"wi": _sd((D, F), dtype), "wg": _sd((D, F), dtype),
                    "wo": _sd((F, D), dtype)}
    return p


def attn_block_shapes(cfg: ModelConfig, layer_idx: int, dtype) -> dict:
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "ln1": _sd((D,), dtype),
        "wq": _sd((D, H * hd), dtype),
        "wk": _sd((D, K * hd), dtype),
        "wv": _sd((D, K * hd), dtype),
        "wo": _sd((H * hd, D), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = _sd((hd,), dtype)
        p["k_norm"] = _sd((hd,), dtype)
    p.update(ffn_shapes(cfg, layer_idx, dtype))
    return p


def mamba_block_shapes(cfg: ModelConfig, dtype) -> dict:
    D = cfg.d_model
    d_inner, n_heads, d_in_proj, d_conv_ch = mamba_dims(cfg)
    return {
        "ln": _sd((D,), dtype),
        "in_proj": _sd((D, d_in_proj), dtype),
        "conv_w": _sd((cfg.ssm.conv_dim, d_conv_ch), dtype),
        "conv_b": _sd((d_conv_ch,), dtype),
        "A_log": _sd((n_heads,), torch.float32),
        "D": _sd((n_heads,), torch.float32),
        "dt_bias": _sd((n_heads,), torch.float32),
        "norm": _sd((d_inner,), dtype),
        "out_proj": _sd((d_inner, D), dtype),
    }


def block_shapes(cfg: ModelConfig, layer_idx: int, dtype) -> dict:
    kind = cfg.layer_kind(layer_idx)
    if kind == ATTN:
        return attn_block_shapes(cfg, layer_idx, dtype)
    p = mamba_block_shapes(cfg, dtype)      # check_supported: ATTN, MAMBA
    p.update(ffn_shapes(cfg, layer_idx, dtype))
    return p


def check_supported(cfg: ModelConfig):
    """The port's model covers decoder-only stacks of attention and mamba
    blocks (MoE FFNs are refused by ``ffn_shapes``)."""
    if (cfg.is_encoder_decoder or cfg.frontend.kind != "none"
            or any(b not in (ATTN, MAMBA) for b in cfg.block_pattern)):
        raise NotImplementedError(
            f"{cfg.name}: only attention and mamba stacks are ported so "
            "far; xLSTM, encoder-decoder and vision come with ROADMAP "
            "Queue 1 item 7 (other model families)")


def param_shapes(cfg: ModelConfig, param_dtype=torch.float32) -> dict:
    check_supported(cfg)
    dt = param_dtype
    D, Vp = cfg.d_model, padded_vocab(cfg)
    plen = len(cfg.block_pattern)
    periods = cfg.num_layers // plen
    layers = {f"block{j}": tree_map(lambda s: _sd((periods,) + s.shape,
                                                  s.dtype),
                                    block_shapes(cfg, j, dt))
              for j in range(plen)}
    tree = {"embed": {"tok": _sd((Vp, D), dt)},
            "decoder": {"layers": layers, "final_norm": _sd((D,), dt)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = _sd((D, Vp), dt)
    return tree


def count_params_config(cfg: ModelConfig, active_only: bool = False) -> int:
    # dense FFNs only, so every parameter is active
    return sum(int(np.prod(s.shape)) for s in tree_leaves(param_shapes(cfg)))


def _truncated_normal(shape, gen, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by inverting the CDF of a
    uniform draw from ``gen``."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    x = torch.special.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return (x * math.sqrt(2.0)).clamp_(-2.0, 2.0)


def _override(name: str, x: torch.Tensor) -> torch.Tensor:
    """The JAX init's fixed values for the mamba leaves, over the last
    (head) axis and broadcast over the period axis: ``A_log`` spans
    log(1..8), so A = -exp(A_log) in [-8, -1]; ``dt_bias`` is softplus^-1
    of dt log-spaced in [1e-3, 1e-1]; ``D`` is ones. Other leaves pass."""
    n = x.shape[-1] if x.dim() else 1
    if name == "A_log":
        v = torch.log(torch.linspace(1.0, 8.0, n, device=x.device))
    elif name == "dt_bias":
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), n,
                                      device=x.device))
        v = torch.log(torch.expm1(dt))
    elif name == "D":
        v = torch.ones(n, device=x.device)
    else:
        return x
    return v.expand(x.shape).clone()


def init_params(cfg: ModelConfig, seed: int = 0, param_dtype=torch.float32,
                device="cuda") -> dict:
    """Fan-in scaled truncated-normal init over the shape tree, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed`` (matrices:
    ``N(0,1)`` truncated to [-2, 2] over sqrt(fan_in), with the period
    axis counted in the fan-in as in JAX; vectors: ones), then the JAX
    init's overrides of the mamba leaves (``_override``). Same leaves,
    shapes and distribution as the JAX init, not the same bits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for path, sd in tree_items(param_shapes(cfg, param_dtype)):
        shp = sd.shape
        if len(shp) >= 2:
            fan_in = int(np.prod(shp[:-1]))
            x = _truncated_normal(shp, gen, dev) / math.sqrt(max(fan_in, 1))
        else:
            x = torch.ones(shp, dtype=torch.float32, device=dev)
        x = _override(path[-1], x)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x.to(sd.dtype)
    return out
