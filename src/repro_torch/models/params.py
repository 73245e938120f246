"""Parameter trees of the port (mirrors ``repro.models.params``).

``param_shapes(cfg)`` builds the tree of ``ShapeDtype`` leaves,
``init_params`` materializes it on a device from a seed, and
``count_params_config`` folds it. Leaf names, shapes, dtypes and the
period-stacked leading ``(num_periods,)`` axis are the JAX package's, so
``repro_torch.interop`` converts either way leaf for leaf: attention
blocks (with the cross-attention leaves of an encoder-decoder's
decoder), mamba, mLSTM and sLSTM blocks, each followed by its FFN — the
dense SwiGLU, the MoE experts with their fp32 router, or both (a dense
residual beside the experts); an ``encoder`` stack of attention blocks
for encoder-decoder models.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.tree import tree_items, tree_map

VOCAB_PAD = 128  # pad vocab so TP over the model axis always divides


class ShapeDtype(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def _sd(shape, dtype) -> ShapeDtype:
    return ShapeDtype(tuple(int(s) for s in shape), dtype)


# ---------------------------------------------------------------------------
# derived dims
# ---------------------------------------------------------------------------
def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm.head_dim
    # in_proj emits [x (d_inner), z (d_inner), B (d_state), C (d_state),
    #                dt (n_heads)]
    d_in_proj = 2 * d_inner + 2 * cfg.ssm.d_state + n_heads
    d_conv_ch = d_inner + 2 * cfg.ssm.d_state   # conv over x, B, C
    return d_inner, n_heads, d_in_proj, d_conv_ch


def mlstm_dims(cfg: ModelConfig):
    di = int(cfg.xlstm.proj_factor * cfg.d_model)
    di = (di // cfg.xlstm.head_dim) * cfg.xlstm.head_dim
    n_heads = di // cfg.xlstm.head_dim
    return di, n_heads


def slstm_dims(cfg: ModelConfig):
    # simplified sLSTM: recurrence at d_model width, per-head block-diagonal
    # recurrent weights, post-recurrence GLU at slstm_proj_factor
    heads = cfg.num_heads
    dh = cfg.d_model // heads
    d_up = int(cfg.xlstm.slstm_proj_factor * cfg.d_model)
    d_up = (d_up // 8) * 8
    return heads, dh, d_up


# ---------------------------------------------------------------------------
# per-block shapes (logical, un-stacked)
# ---------------------------------------------------------------------------
def ffn_shapes(cfg: ModelConfig, layer_idx: int, dtype) -> dict:
    """FFN half of a block — orthogonal to the mixer kind (jamba has an
    MLP/MoE after every mixer, attention or mamba alike)."""
    D = cfg.d_model
    has_moe = cfg.layer_has_moe(layer_idx)
    dense = (cfg.d_ff > 0) and (not has_moe or
                                (cfg.moe and cfg.moe.dense_residual))
    p = {}
    if dense or has_moe:
        p["ln2"] = _sd((D,), dtype)
    if dense:
        F = cfg.d_ff
        p["ffn"] = {"wi": _sd((D, F), dtype), "wg": _sd((D, F), dtype),
                    "wo": _sd((F, D), dtype)}
    if has_moe:
        E, Fe = cfg.moe.num_experts, cfg.moe.d_ff
        p["moe"] = {
            "router": _sd((D, E), torch.float32),   # router in fp32
            "wi": _sd((E, D, Fe), dtype),
            "wg": _sd((E, D, Fe), dtype),
            "wo": _sd((E, Fe, D), dtype),
        }
    return p


def attn_block_shapes(cfg: ModelConfig, layer_idx: int, dtype,
                      cross: bool = False) -> dict:
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
    if cross:
        p["ln_x"] = _sd((D,), dtype)
        p["xq"] = _sd((D, H * hd), dtype)
        p["xk"] = _sd((D, K * hd), dtype)
        p["xv"] = _sd((D, K * hd), dtype)
        p["xo"] = _sd((H * hd, D), dtype)
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


def mlstm_block_shapes(cfg: ModelConfig, dtype) -> dict:
    D = cfg.d_model
    di, n_heads = mlstm_dims(cfg)
    return {
        "ln": _sd((D,), dtype),
        "w_up": _sd((D, 2 * di), dtype),       # x and gate branches
        "wq": _sd((di, di), dtype),
        "wk": _sd((di, di), dtype),
        "wv": _sd((di, di), dtype),
        "w_i": _sd((di, n_heads), torch.float32),  # exp-gate projections
        "w_f": _sd((di, n_heads), torch.float32),
        "b_i": _sd((n_heads,), torch.float32),
        "b_f": _sd((n_heads,), torch.float32),
        "norm": _sd((di,), dtype),
        "w_out": _sd((di, D), dtype),
    }


def slstm_block_shapes(cfg: ModelConfig, dtype) -> dict:
    D = cfg.d_model
    heads, dh, d_up = slstm_dims(cfg)
    gates = {}
    for g in ("z", "i", "f", "o"):
        gates[f"w_{g}"] = _sd((D, D), dtype)
        gates[f"r_{g}"] = _sd((heads, dh, dh), dtype)   # block-diag recurrent
        gates[f"b_{g}"] = _sd((D,), torch.float32)
    return {
        "ln": _sd((D,), dtype),
        **gates,
        "norm": _sd((D,), dtype),
        "up_wi": _sd((D, d_up), dtype),
        "up_wg": _sd((D, d_up), dtype),
        "up_wo": _sd((d_up, D), dtype),
    }


def block_shapes(cfg: ModelConfig, layer_idx: int, dtype,
                 cross: bool = False) -> dict:
    kind = cfg.layer_kind(layer_idx)
    if kind == ATTN:
        return attn_block_shapes(cfg, layer_idx, dtype, cross=cross)
    if kind == MAMBA:
        p = mamba_block_shapes(cfg, dtype)
    elif kind == MLSTM:
        p = mlstm_block_shapes(cfg, dtype)
    elif kind == SLSTM:
        p = slstm_block_shapes(cfg, dtype)
    else:
        raise ValueError(kind)
    p.update(ffn_shapes(cfg, layer_idx, dtype))
    return p


# ---------------------------------------------------------------------------
# full tree
# ---------------------------------------------------------------------------
def stack_param_shapes(cfg: ModelConfig, dtype, num_layers: int,
                       cross: bool = False) -> dict:
    """Period-stacked shapes for a stack of ``num_layers`` blocks (block j
    of the pattern takes the FFN of layer j, as in JAX)."""
    plen = len(cfg.block_pattern)
    assert num_layers % plen == 0
    periods = num_layers // plen
    return {f"block{j}": tree_map(
                lambda s: _sd((periods,) + s.shape, s.dtype),
                block_shapes(cfg, j, dtype, cross=cross))
            for j in range(plen)}


def param_shapes(cfg: ModelConfig, param_dtype=torch.float32) -> dict:
    dt = param_dtype
    D, Vp = cfg.d_model, padded_vocab(cfg)
    tree = {
        "embed": {"tok": _sd((Vp, D), dt)},
        "decoder": {
            "layers": stack_param_shapes(cfg, dt, cfg.num_layers,
                                         cross=cfg.is_encoder_decoder),
            "final_norm": _sd((D,), dt),
        },
    }
    if cfg.is_encoder_decoder:
        # encoder blocks are plain attention blocks (bidirectional at
        # apply time); the audio frontend is a stub (precomputed frames)
        tree["encoder"] = {
            "layers": stack_param_shapes(cfg, dt, cfg.num_encoder_layers),
            "final_norm": _sd((D,), dt),
        }
    if not cfg.tie_embeddings:
        tree["lm_head"] = _sd((D, Vp), dt)
    return tree


def count_params_config(cfg: ModelConfig, active_only: bool = False) -> int:
    items = list(tree_items(param_shapes(cfg)))
    total = sum(int(np.prod(s.shape)) for _, s in items)
    if active_only and cfg.moe is not None:
        # subtract the inactive expert fraction of the MoE weights
        moe_total = sum(int(np.prod(s.shape)) for path, s in items
                        if "moe" in path and path[-1] != "router")
        frac = cfg.moe.num_experts_per_token / cfg.moe.num_experts
        total = total - int(moe_total * (1.0 - frac))
    return total


def _truncated_normal(shape, gen, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by inverting the CDF of a
    uniform draw from ``gen``."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    # in place, so a leaf takes one fp32 buffer (an expert stack of
    # arctic's is 17.8 GB of it)
    x = u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_()
    return x.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def _override(name: str, x: torch.Tensor) -> torch.Tensor:
    """The JAX init's fixed values, over the last (head or channel) axis
    and broadcast over the period axis: the xLSTM gate biases ``b_*`` are
    zeros; ``A_log`` spans log(1..8), so A = -exp(A_log) in [-8, -1];
    ``dt_bias`` is softplus^-1 of dt log-spaced in [1e-3, 1e-1]; ``D`` is
    ones. Other leaves pass."""
    n = x.shape[-1] if x.dim() else 1
    if name in ("b_i", "b_f", "b_z", "b_o"):
        return torch.zeros_like(x)
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
    init's overrides (``_override``). Same leaves,
    shapes and distribution as the JAX init, not the same bits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {}
    for path, sd in tree_items(param_shapes(cfg, param_dtype)):
        shp = sd.shape
        if len(shp) >= 2:
            fan_in = int(np.prod(shp[:-1]))
            x = _truncated_normal(shp, gen, dev).div_(
                math.sqrt(max(fan_in, 1)))
        else:
            x = torch.ones(shp, dtype=torch.float32, device=dev)
        x = _override(path[-1], x)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x.to(sd.dtype)
    return out
