"""Model orchestration for stacks of attention and mamba blocks: the
attention mixer, block dispatch by kind, the FFN, a Python loop over the
period-stacked layers, and the prefill and decode entry points (mirrors
``repro.models.model``). Decode runs over the paged KV pool with per-slot
positions (the serve engine), or over a dense cache with one position
for the whole batch (``make_serve_steps``'s generate path).

Cache updates are in place. JAX writes the cache functionally
(``cache["k"].at[pids, offs].set(...)``), which XLA turns into an
in-place update inside ``jit``; done the same way in eager PyTorch it
would copy the whole page pool for every layer of every step. Here the
stack loop hands each layer a view (``pool[i]``) of the stacked cache
leaves, and the decode writes (KV rows, and a mamba layer's conv and SSM
state) land through those views, so ``decode_step`` returns the very
tensors it was given, updated. Anything that must not see later writes
(a pause snapshot) takes a copy: see ``ServeEngine.export_state``.

Matrix products in float32 run in full float32 on the card: the port
leaves ``torch.backends.cuda.matmul.allow_tf32`` at False, and its entry
points set it so.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import (ATTN, MAMBA, ModelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models.attention import (attention, decode_attention,
                                          paged_decode_attention)
from repro_torch.models.layers import (apply_rope, embed_lookup, rms_norm,
                                       swiglu)
from repro_torch.models.ssm import mamba_block
from repro_torch.tree import tree_map

ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}


def _dt(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def ops_backend(run: RunConfig) -> str:
    """RunConfig.kernel_backend -> the ``backend`` of kernels.ops."""
    backends = {"auto": "auto", "reference": "ref"}
    if run.kernel_backend not in backends:
        raise ValueError(f"kernel_backend {run.kernel_backend!r}: the port "
                         f"takes {sorted(backends)}")
    return backends[run.kernel_backend]


# ===========================================================================
# attention mixer
# ===========================================================================
def _attn_mixer(cfg: ModelConfig, p: dict, x, cdt, mode, cache, positions,
                pos, backend, causal=True, tables=None, active=None):
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln1"], cfg.norm_eps).to(cdt)
    q = (h @ p["wq"].to(cdt)).reshape(B, S, H, hd)
    k = (h @ p["wk"].to(cdt)).reshape(B, S, K, hd)
    v = (h @ p["wv"].to(cdt)).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "decode" and tables is None:
        # dense cache, one position for the whole batch: the new row lands
        # at index pos of this layer's view (B, T, K, hd), in place — JAX's
        # dynamic_update_slice. An int pos slices; a 0-d tensor indexes.
        if isinstance(pos, torch.Tensor):
            at = pos.reshape(1).to(torch.int64)
            cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
        else:
            cache["k"][:, pos:pos + 1] = k
            cache["v"][:, pos:pos + 1] = v
        o = decode_attention(q, cache["k"], cache["v"], pos, backend=backend)
    elif mode == "decode":
        # paged KV: the cache leaf is this layer's view of the shared page
        # pool (P, page, K, hd); slot b's new token lands in page
        # tables[b, pos//page] at offset pos%page, written in place.
        # Inactive slots (active[b] False) are redirected to the reserved
        # garbage page 0, so an idle slot's pages stay untouched and its
        # attention (pos[b] = -1 -> zero valid tokens) reads none.
        page = cache["k"].shape[1]
        posw = pos.to(torch.int64).clamp(min=0)
        rows = torch.arange(B, device=x.device)
        pids = tables.to(torch.int64)[rows, posw // page]
        offs = posw % page
        if active is not None:
            pids = torch.where(active, pids, torch.zeros_like(pids))
        if "k_scale" in cache:
            # int8 pool (kv_dtype='int8'): quantize the new token's row on
            # write — per-(slot,head) symmetric scale over hd — and land
            # scale + int8 payload at the same (page, offset)
            from repro_torch.serve.paged import kv_quantize
            kq, ks = kv_quantize(k[:, 0])
            vq, vs = kv_quantize(v[:, 0])
            cache["k"][pids, offs] = kq
            cache["v"][pids, offs] = vq
            cache["k_scale"][pids, offs] = ks
            cache["v_scale"][pids, offs] = vs
            o = paged_decode_attention(q, cache["k"], cache["v"], tables, pos,
                                       k_scale=cache["k_scale"],
                                       v_scale=cache["v_scale"],
                                       backend=backend)
        else:
            cache["k"][pids, offs] = k[:, 0].to(cache["k"].dtype)
            cache["v"][pids, offs] = v[:, 0].to(cache["v"].dtype)
            o = paged_decode_attention(q, cache["k"], cache["v"], tables, pos,
                                       backend=backend)
    elif mode in ("train", "prefill"):
        o = attention(q, k, v, causal=causal, backend=backend)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    else:
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (chunked prefill: ROADMAP "
            "deferred serve-engine parts)")
    out = o.reshape(B, S, H * hd).to(cdt) @ p["wo"].to(cdt)
    return out, new_cache


def _apply_ffn(cfg: ModelConfig, p: dict, x, cdt):
    if "ln2" not in p:
        return x
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y = swiglu(h, p["ffn"]["wi"], p["ffn"]["wg"], p["ffn"]["wo"], cdt)
    return x + y.to(x.dtype)


def _write_state(cache_j: dict, nc: dict, active):
    """Land a recurrent block's new decode state in its cache views, in
    place. An inactive slot (``active[b]`` False) keeps its old bytes, so
    its state stays bit-untouched (its row would otherwise integrate the
    garbage token)."""
    for name, new in nc.items():
        old = cache_j[name]
        if active is not None:
            keep = active.reshape(active.shape + (1,) * (new.dim() - 1))
            new = torch.where(keep, new.to(old.dtype), old)
        old.copy_(new)


def _apply_block(cfg, run: RunConfig, kind: str, p, x, mode, cache_j,
                 positions, pos, causal=True, tables=None, active=None):
    """One block of ``kind`` (ATTN or MAMBA: see check_supported), then
    its FFN. Returns (x, the block's new cache in prefill, else None)."""
    cdt = _dt(run.precision.compute)
    backend = ops_backend(run)
    if kind == ATTN:
        out, nc = _attn_mixer(cfg, p, x, cdt, mode, cache_j, positions, pos,
                              backend, causal=causal, tables=tables,
                              active=active)
    elif kind == MAMBA:
        out, nc = mamba_block(cfg, p, x, cdt, mode=mode, cache=cache_j,
                              backend=backend)
        if mode == "decode":
            _write_state(cache_j, nc, active)
            nc = None
    else:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    x = _apply_ffn(cfg, p, x + out, cdt)
    return x, nc


# ===========================================================================
# the layer stack: a Python loop over periods
# ===========================================================================
def run_stack(cfg: ModelConfig, run: RunConfig, layers: dict, x, mode,
              cache=None, positions=None, pos=None, tables=None,
              active=None):
    """Loop over the (period-stacked) layer stack.

    layers: {"block{j}": tree stacked over periods}
    cache: same structure; prefill returns a fresh stacked cache, decode
    updates ``cache`` in place (through per-period views) and returns it.
    """
    P.check_supported(cfg)
    pattern = cfg.block_pattern
    nper = cfg.num_layers // len(pattern)
    new = {f"block{j}": [] for j in range(len(pattern))}
    for i in range(nper):
        for j in range(len(pattern)):
            name = f"block{j}"
            pp = tree_map(lambda leaf: leaf[i], layers[name])
            cj = (tree_map(lambda leaf: leaf[i], cache[name])
                  if cache is not None else None)
            x, nc = _apply_block(cfg, run, pattern[j], pp, x, mode, cj,
                                 positions, pos, tables=tables,
                                 active=active)
            if nc is not None:
                new[name].append(nc)
    if mode == "prefill":
        cache = {name: {k: torch.stack([nc[k] for nc in per])
                        for k in per[0]}
                 for name, per in new.items()}
    return x, dict(ZERO_AUX), cache


# ===========================================================================
# the Model
# ===========================================================================
class Model:
    """Functional model bound to a RunConfig."""

    def __init__(self, run: RunConfig):
        self.run = run
        self.cfg = run.model
        P.check_supported(self.cfg)
        ops_backend(run)                  # reject an unknown backend early
        self._pos_tables = {}             # device -> arange, see _positions

    # -- params -------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> dict:
        return P.init_params(self.cfg, seed, _dt(self.run.precision.params),
                             device)

    def param_shapes(self) -> dict:
        return P.param_shapes(self.cfg, _dt(self.run.precision.params))

    def compute_params(self, params) -> dict:
        """``params`` as the forward pass reads them: the layer stack's
        matrices cast once to the compute dtype. The forward casts each
        matrix where it uses it (``.to(cdt)``, as the JAX package does
        inside ``jit``, where XLA hoists the cast); in eager PyTorch that
        is a copy of every weight on every call, while a matrix already
        in the compute dtype passes through untouched. Norm weights, the
        mamba conv weights and per-head vectors, the embedding and the
        head keep their dtype: they are read in fp32."""
        cdt = _dt(self.run.precision.compute)

        def cast(node):
            return {k: (cast(w) if isinstance(w, dict) else
                        w.to(cdt) if w.dim() >= 3 and k != "conv_w" else w)
                    for k, w in node.items()}
        layers = cast(params["decoder"]["layers"])
        return dict(params, decoder=dict(params["decoder"], layers=layers))

    # -- embedding / head ----------------------------------------------------
    def _embed(self, params, tokens, cdt):
        return embed_lookup(params["embed"]["tok"], tokens, cdt)

    def _logits(self, params, x):
        ldt = _dt(self.run.precision.logits)
        if self.cfg.tie_embeddings:
            w = params["embed"]["tok"]
            return x.to(ldt) @ w.to(ldt).T
        return x.to(ldt) @ params["lm_head"].to(ldt)

    def _hidden(self, params, batch, mode):
        cfg, run = self.cfg, self.run
        x = self._embed(params, batch["tokens"], _dt(run.precision.compute))
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux, cache = run_stack(cfg, run, params["decoder"]["layers"], x,
                                  mode, positions=positions)
        x = rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)
        return x, aux, cache

    # -- forward (train / prefill) -------------------------------------------
    def forward(self, params, batch, mode="train"):
        x, aux, cache = self._hidden(params, batch, mode)
        return self._logits(params, x), aux, cache

    # -- serving -------------------------------------------------------------
    def prefill(self, params, batch):
        """Returns (cache, last_logits). Only the last position's logits
        are computed: they are all the serve path reads."""
        x, _, cache = self._hidden(params, batch, "prefill")
        return cache, self._logits(params, x[:, -1:])[:, 0]

    def decode_step(self, params, cache, tokens, pos, *, tables=None,
                    active=None):
        """tokens: (B,1) int; pos: the position the new token occupies
        (attends to <= pos). Returns (logits (B,V), cache), the cache
        updated in place.

        Two layouts. With ``tables`` ((B,NP) int32 paged-KV block
        tables), attention-cache leaves are page pools (nper, P, page,
        K, hd) — see ``repro_torch.serve.paged`` — and ``pos`` is (B,)
        int32, per slot. Without, the cache is ``init_cache``'s dense one
        and ``pos`` one position for the whole batch (an int or a 0-d
        tensor); the per-slot dense ring is not ported yet.

        active: optional (B,) bool, paged layout — False rows are masked
        OUT of the decode: their KV writes go to the garbage page 0,
        their attention reads zero tokens (pos[b] must be < 0 for them)
        and their recurrent state stays bit-untouched. Their logits are
        garbage and must be discarded."""
        cfg, run = self.cfg, self.run
        x = self._embed(params, tokens, _dt(run.precision.compute))
        if tables is None:
            if isinstance(pos, torch.Tensor) and pos.dim() != 0:
                raise NotImplementedError(
                    "the dense cache with per-slot positions (the dense "
                    "ring layout) is not ported yet (ROADMAP Queue 1 item "
                    "5)")
            if isinstance(pos, torch.Tensor):
                pos = pos.to(x.device)
                positions = pos.reshape(1).to(torch.int64)
            else:
                # an int stays an int down to the cache write and the
                # kernel (an argument, not a tensor)
                pos = int(pos)
                positions = self._positions(pos, x.device)
        else:
            # rope positions must be in-range even for inactive (-1) slots
            positions = pos.to(torch.int64).clamp(min=0)[:, None]
        x, _, cache = run_stack(cfg, run, params["decoder"]["layers"], x,
                                "decode", cache=cache, positions=positions,
                                pos=pos, tables=tables, active=active)
        x = rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)
        return self._logits(params, x)[:, 0], cache

    def _positions(self, pos: int, device) -> torch.Tensor:
        """The rope position (1,) int64 of an int ``pos``: a view of an
        arange made once per device (grown by doubling), so a decode step
        launches no kernel to make it."""
        if pos < 0:
            raise ValueError(f"decode position {pos} < 0")
        table = self._pos_tables.get(device)
        if table is None or table.numel() <= pos:
            table = torch.arange(max(1024, 2 * (pos + 1)), device=device)
            self._pos_tables[device] = table
        return table[pos:pos + 1]

    # -- caches --------------------------------------------------------------
    def cache_specs(self, shape: Optional[ShapeConfig] = None) -> dict:
        """Dense decode-cache leaves as ShapeDtype, (periods, B, ...) per
        block: k, v (.., S, K, hd) for attention; for mamba the conv tail
        (.., conv-1, ch) in the compute dtype and the SSM state (.., heads,
        hd, N) in fp32."""
        cfg = self.cfg
        shape = shape or self.run.shape
        B, S = shape.global_batch, shape.seq_len
        cdt = _dt(self.run.precision.compute)
        nper = cfg.num_layers // len(cfg.block_pattern)

        def sd(shp, dt=cdt):
            return P.ShapeDtype((nper,) + shp, dt)

        tree = {}
        for j, kind in enumerate(cfg.block_pattern):
            if kind == ATTN:
                kv = sd((B, S, cfg.num_kv_heads, cfg.head_dim))
                tree[f"block{j}"] = {"k": kv, "v": kv}
            else:                       # MAMBA (see check_supported)
                _, nh, _, ch = P.mamba_dims(cfg)
                tree[f"block{j}"] = {
                    "conv": sd((B, cfg.ssm.conv_dim - 1, ch)),
                    "ssm": sd((B, nh, cfg.ssm.head_dim, cfg.ssm.d_state),
                              torch.float32)}
        return tree

    def init_cache(self, shape: Optional[ShapeConfig] = None,
                   device="cuda") -> dict:
        dev = resolve_device(device)
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=dev),
                        self.cache_specs(shape))


def build_model(run: RunConfig) -> Model:
    return Model(run)
