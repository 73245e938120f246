"""Model orchestration: the attention and cross-attention mixers, block
dispatch by kind (attention, mamba, mLSTM, sLSTM), the FFN (dense, MoE or
both), a Python loop over the period-stacked layers, the encoder of an
encoder-decoder, the vision patches, the train-mode forward and loss, and
the prefill, chunked-prefill and decode entry points (mirrors
``repro.models.model``). While autograd records, the train mode runs the
plain attention and SSM scan (the CUDA kernels compute forward only)
and, unless ``run.sharding.remat`` is "none", recomputes each period in
the backward (``torch.utils.checkpoint``). Decode runs over the paged KV
pool with per-slot positions (the serve engine), or over a dense cache
with one position for the whole batch (``make_serve_steps``'s generate
path) or per-slot positions (the serve engine's dense ring).

Cache updates are in place. JAX writes the cache functionally
(``cache["k"].at[pids, offs].set(...)``), which XLA turns into an
in-place update inside ``jit``; done the same way in eager PyTorch it
would copy the whole page pool for every layer of every step. Here the
stack loop hands each layer a view (``pool[i]``) of the stacked cache
leaves, and the decode writes (KV rows, and a recurrent layer's state)
land through those views, so ``decode_step`` returns the very tensors it
was given, updated. Anything that must not see later writes (a pause
snapshot) takes a copy: see ``ServeEngine.export_state``.

Matrix products in float32 run in full float32 on the card: the port
leaves ``torch.backends.cuda.matmul.allow_tf32`` at False, and its entry
points set it so.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, MAMBA, MLSTM, SLSTM,
                                      ModelConfig, RunConfig, ShapeConfig)
from repro_torch.device import resolve_device
from repro_torch.models import params as P
from repro_torch.models.attention import (attention, decode_attention,
                                          paged_decode_attention)
from repro_torch.models.layers import (apply_rope, embed_lookup, rms_norm,
                                       swiglu)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import mamba_block
from repro_torch.models.xlstm import mlstm_block, slstm_block
from repro_torch.runtime.partitioning import (constrain, current_rules,
                                              is_dtensor, settle,
                                              sharding_scope)
from repro_torch.tree import tree_items, tree_map

_BLOCK_FNS = {MAMBA: mamba_block, MLSTM: mlstm_block, SLSTM: slstm_block}
#: matrices a block reads in fp32 whatever the compute dtype, which
#: ``Model.compute_params`` leaves as they are
_READ_FP32 = {MAMBA: ("conv_w",), MLSTM: ("w_i", "w_f"),
              SLSTM: ("r_z", "r_i", "r_f", "r_o")}
ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}
NEG_LOGIT = -1e30           # the masked vocab tail's logit
STATE_M0 = -1e30            # a fresh cache's exp-gate stabilizers ("m")


def _dt(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def ops_backend(run: RunConfig) -> str:
    """RunConfig.kernel_backend -> the ``backend`` of kernels.ops.
    ``"pallas"`` is the JAX package's name for its kernels: here the hand
    kernels on CUDA tensors, as ``"auto"``."""
    backends = {"auto": "auto", "pallas": "auto", "reference": "ref"}
    if run.kernel_backend not in backends:
        raise ValueError(f"kernel_backend {run.kernel_backend!r}: the port "
                         f"takes {sorted(backends)}")
    return backends[run.kernel_backend]


# ===========================================================================
# attention mixer
# ===========================================================================
def _heads(t, n: int, hd: int):
    """(B, S, n * hd) -> (B, S, n, hd). On a DTensor whose last dim is
    sharded over more parts than ``n`` heads divide into (the kv heads of
    "seq" mode), that dim is gathered first: a view cannot split a shard
    across heads."""
    if not is_dtensor(t):
        return t.reshape(t.shape[0], t.shape[1], n, hd)
    mesh = t.device_mesh
    fix = [Replicate() if p.is_shard() and p.dim in (-1, t.dim() - 1)
           and n % mesh.size(i) else p for i, p in enumerate(t.placements)]
    if fix != list(t.placements):
        t = t.redistribute(mesh, fix)
    return _ContiguousGrad.apply(t.reshape(t.shape[0], t.shape[1], n, hd))


class _ContiguousGrad(torch.autograd.Function):
    """The identity on a DTensor, whose backward makes the gradient's
    local tensor contiguous: the view in a reshape's backward fails on
    the transposed local gradient the attention's backward hands over
    (a DTensor reports its global strides, so ``.contiguous()`` on it
    does not reach the local tensor)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh,
                                  g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())


def _attn_mixer(cfg: ModelConfig, p: dict, x, cdt, mode, cache, positions,
                pos, backend, causal=True, tables=None, active=None):
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln1"], cfg.norm_eps).to(cdt)
    if mode != "decode":
        h = constrain(h, "hidden_full")   # SP: gather seq for TP qkv
    q = _heads(h @ p["wq"].to(cdt), H, hd)
    k = _heads(h @ p["wk"].to(cdt), K, hd)
    v = _heads(h @ p["wv"].to(cdt), K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mode != "decode":
        q = constrain(q, "attn_q")
        k = constrain(k, "attn_kv")
        v = constrain(v, "attn_kv")

    new_cache = None
    if mode == "decode" and tables is None:
        # dense cache: the new row lands in this layer's view (B, T, K,
        # hd), in place. Per-slot positions, a (B,) tensor (the dense
        # ring): slot b's row at index max(pos[b], 0). One position for
        # the whole batch: JAX's dynamic_update_slice, an int pos slices
        # and a 0-d tensor indexes.
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            rows = torch.arange(B, device=x.device)
            posw = pos.to(torch.int64).clamp(min=0)
            knew = k[:, 0].to(cache["k"].dtype)
            vnew = v[:, 0].to(cache["v"].dtype)
            if active is not None:
                # masked scatter: an inactive slot writes back the bytes
                # it already holds (gathered into a fresh tensor before
                # the write), so its rows stay bit-untouched and nothing
                # lands at row 0 of an empty slot; one row per slot, so
                # the scatter's targets are distinct
                keep = active[:, None, None]
                knew = torch.where(keep, knew, cache["k"][rows, posw])
                vnew = torch.where(keep, vnew, cache["v"][rows, posw])
            cache["k"][rows, posw] = knew
            cache["v"][rows, posw] = vnew
        elif isinstance(pos, torch.Tensor):
            at = pos.reshape(1).to(torch.int64)
            cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
        else:
            cache["k"][:, pos:pos + 1] = k
            cache["v"][:, pos:pos + 1] = v
        o = decode_attention(q, constrain(cache["k"], "kv_cache"),
                             constrain(cache["v"], "kv_cache"), pos,
                             backend=backend)
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
    elif mode == "prefill_chunk":
        # chunked-prefill continuation: this chunk's KV lands at offset
        # ``pos`` (a 0-d tensor) of the dense staging cache, in place, and
        # the chunk attends causally against everything cached so far —
        # the plain attention, as JAX's traced offset takes it (the not-
        # yet-written tail and any chunk padding sit past every query)
        at = pos.to(torch.int64) + torch.arange(S, device=x.device)
        cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
        o = attention(q, cache["k"], cache["v"], causal=True, q_offset=pos,
                      backend=backend)
    else:                                   # train / prefill
        o = attention(q, k, v, causal=causal, backend=backend)
        if mode == "prefill":
            new_cache = {"k": constrain(k, "kv_cache"),
                         "v": constrain(v, "kv_cache")}
        o = constrain(o, "attn_q")
    out = _seq_major_mm(o.reshape(B, S, H * hd).to(cdt), p["wo"].to(cdt))
    if mode != "decode":
        out = constrain(out, "hidden")
    return out, new_cache


def _seq_major_mm(x, w):
    """``x @ w``. A (B, S, F) DTensor split over its sequence (the "seq"
    mode's attention output) is multiplied sequence-major: the product
    flattens (B, S), which a view cannot do with S split (torch 2.11's
    DTensor refuses), while (S, B) with S split flattens in place."""
    if is_dtensor(x) and x.dim() == 3 and any(
            p.is_shard(1) for p in x.placements):
        return (x.transpose(0, 1) @ w).transpose(0, 1)
    return x @ w


def _cross_mixer(cfg: ModelConfig, p: dict, x, cdt, mode, cache, memory,
                 backend):
    """Encoder-decoder cross attention, non-causal over the memory's Te
    rows. memory: (B, Te, D), or None in decode, where the projected
    memory (xk/xv) is read from the cache."""
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln_x"], cfg.norm_eps).to(cdt)
    q = (h @ p["xq"].to(cdt)).reshape(B, S, H, hd)
    if mode == "decode":
        xk, xv = cache["xk"], cache["xv"]
    else:
        m = memory.to(cdt)
        Te = m.shape[1]
        xk = (m @ p["xk"].to(cdt)).reshape(B, Te, K, hd)
        xv = (m @ p["xv"].to(cdt)).reshape(B, Te, K, hd)
    o = attention(q, xk, xv, causal=False, backend=backend)
    out = o.reshape(B, S, H * hd).to(cdt) @ p["xo"].to(cdt)
    new_cache = {"xk": xk, "xv": xv} if mode == "prefill" else None
    return out, new_cache


def _apply_ffn(cfg: ModelConfig, p: dict, x, cdt):
    """The block's FFN: the dense SwiGLU, the MoE experts, or both summed
    (a dense residual beside the experts). Returns (x, aux losses)."""
    aux = {}
    if "ln2" not in p:
        return x, aux
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y = None
    if "ffn" in p:
        # SP: the sequence gathered for the TP matmuls, scattered back at
        # the block's "hidden" constraint
        hf = constrain(h, "hidden_full")
        y = swiglu(hf, p["ffn"]["wi"], p["ffn"]["wg"], p["ffn"]["wo"], cdt)
    if "moe" in p:
        ym, aux = moe_ffn(h, p["moe"], cfg.moe, cdt)
        # JAX sums both terms onto zeros_like(x), so at x's dtype
        y = ym if y is None else y.to(x.dtype) + ym
    return x + y.to(x.dtype), aux


def _write_state(cache_j: dict, nc: dict, active):
    """Land a recurrent block's new decode state in its cache views, in
    place (nested trees too: the mLSTM's and sLSTM's states). An inactive
    slot (``active[b]`` False) keeps its old bytes, so its state stays
    bit-untouched (its row would otherwise integrate the garbage
    token)."""
    for name, new in nc.items():
        old = cache_j[name]
        if isinstance(new, dict):
            _write_state(old, new, active)
            continue
        if active is not None:
            keep = active.reshape(active.shape + (1,) * (new.dim() - 1))
            new = torch.where(keep, new.to(old.dtype), old)
        old.copy_(new)


def _apply_block(cfg, run: RunConfig, kind: str, p, x, mode, cache_j,
                 positions, pos, memory=None, causal=True, cross=False,
                 tables=None, active=None):
    """One block of ``kind``, then its FFN. Returns (x, the block's new
    cache in prefill, else None, aux losses)."""
    cdt = _dt(run.precision.compute)
    backend = ops_backend(run)
    if mode == "train" and torch.is_grad_enabled():
        # the kernels compute forward only (``kernels.ops`` refuses them
        # under autograd): training runs the plain versions, as the JAX
        # train step runs attention_ref and ssd_chunked
        backend = "ref"
    if kind == ATTN:
        out, nc = _attn_mixer(cfg, p, x, cdt, mode, cache_j, positions, pos,
                              backend, causal=causal, tables=tables,
                              active=active)
        x = x + out
        if cross:
            out, ncx = _cross_mixer(cfg, p, x, cdt, mode, cache_j, memory,
                                    backend)
            x = x + out
            if ncx:
                nc = dict(nc or {}, **ncx)
    else:
        out, nc = _BLOCK_FNS[kind](cfg, p, x, cdt, mode=mode, cache=cache_j,
                                   backend=backend)
        if mode == "decode":
            _write_state(cache_j, nc, active)
            nc = None
        x = x + out
    x, aux = _apply_ffn(cfg, p, x, cdt)
    return constrain(x, "hidden"), nc, aux


# ===========================================================================
# the layer stack: a Python loop over periods
# ===========================================================================
def run_stack(cfg: ModelConfig, run: RunConfig, layers: dict, x, mode,
              cache=None, positions=None, pos=None, memory=None,
              is_encoder=False, tables=None, active=None):
    """Loop over the (period-stacked) layer stack.

    layers: {"block{j}": tree stacked over periods}
    cache: same structure; prefill returns a fresh stacked cache, decode
    updates ``cache`` in place (through per-period views) and returns it.
    memory: the encoder's output, read by a decoder's cross attention.
    is_encoder: the encoder's stack (attention blocks, non-causal, no
    cache). Returns (x, aux losses summed over the stack, cache).
    """
    pattern = (ATTN,) if is_encoder else cfg.block_pattern
    nper = (cfg.num_encoder_layers if is_encoder
            else cfg.num_layers) // len(pattern)
    causal = not is_encoder
    cross = cfg.is_encoder_decoder and not is_encoder
    new = {f"block{j}": [] for j in range(len(pattern))}
    # each stacked leaf split into its periods once: the backward of
    # ``unbind`` stacks the periods' gradients in one copy, where one
    # ``leaf[i]`` per period would add a full-size zero-padded gradient
    # per period (nper² work)
    periods = tree_map(lambda leaf: leaf.unbind(0), layers)

    def period(x, aux_in, i):
        aux = dict(aux_in)
        ncs = {}
        for j in range(len(pattern)):
            name = f"block{j}"
            pp = tree_map(lambda leaf: leaf[i], periods[name])
            cj = (tree_map(lambda leaf: leaf[i], cache[name])
                  if cache is not None else None)
            x, ncs[name], a = _apply_block(
                cfg, run, pattern[j], pp, x, mode, cj, positions, pos,
                memory=memory, causal=causal, cross=cross, tables=tables,
                active=active)
            for k, v in a.items():
                aux[k] = aux[k] + v
        return x, aux, ncs

    # remat: the backward recomputes each period's forward instead of
    # keeping its activations (JAX's jax.checkpoint of the period; every
    # policy but "none" saves nothing inside the period here)
    remat = (mode == "train" and run.sharding.remat != "none"
             and torch.is_grad_enabled())
    # the recompute runs in the backward, on autograd's device thread on
    # a card: it re-enters the forward's sharding scope itself
    rules = current_rules()

    def recompute(x, aux, i):
        with sharding_scope(rules):
            return period(x, aux, i)[:2]

    aux = dict(ZERO_AUX)
    for i in range(nper):
        if remat:
            x, aux = checkpoint(recompute, x, aux, i, use_reentrant=False)
            continue
        x, aux, ncs = period(x, aux, i)
        for name, nc in ncs.items():
            if nc is not None:
                new[name].append(nc)
    if mode == "prefill" and not is_encoder:
        cache = {name: tree_map(lambda *ls: torch.stack(ls), *per)
                 for name, per in new.items()}
    return x, aux, cache


# ===========================================================================
# the Model
# ===========================================================================
class Model:
    """Functional model bound to a RunConfig."""

    def __init__(self, run: RunConfig):
        self.run = run
        self.cfg = run.model
        ops_backend(run)                  # reject an unknown backend early
        self._pos_tables = {}             # device -> arange, see _positions

    # -- params -------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> dict:
        return P.init_params(self.cfg, seed, _dt(self.run.precision.params),
                             device)

    def param_shapes(self) -> dict:
        return P.param_shapes(self.cfg, _dt(self.run.precision.params))

    def compute_params(self, params) -> dict:
        """``params`` as the forward pass reads them: the layer stacks'
        matrices cast once to the compute dtype. The forward casts each
        matrix where it uses it (``.to(cdt)``, as the JAX package does
        inside ``jit``, where XLA hoists the cast); in eager PyTorch that
        is a copy of every weight on every call, while a matrix already
        in the compute dtype passes through untouched. Norm weights,
        per-head vectors, the matrices a block reads in fp32
        (``_READ_FP32``: the mamba conv, the mLSTM gate projections, the
        sLSTM recurrent weights), the embedding and the head keep their
        dtype."""
        cdt = _dt(self.run.precision.compute)

        def cast(node, keep=()):
            return {k: (cast(w) if isinstance(w, dict) else
                        w.to(cdt) if w.dim() >= 3 and k not in keep else w)
                    for k, w in node.items()}

        def stack(layers, pattern):
            return {f"block{j}": cast(layers[f"block{j}"],
                                      _READ_FP32.get(kind, ()))
                    for j, kind in enumerate(pattern)}

        out = dict(params, decoder=dict(
            params["decoder"], layers=stack(params["decoder"]["layers"],
                                            self.cfg.block_pattern)))
        if "encoder" in params:
            out["encoder"] = dict(params["encoder"], layers=stack(
                params["encoder"]["layers"], (ATTN,)))
        return out

    # -- embedding / head ----------------------------------------------------
    def _embed(self, params, tokens, cdt):
        return embed_lookup(params["embed"]["tok"], tokens, cdt)

    def _logits(self, params, x):
        ldt = _dt(self.run.precision.logits)
        if self.cfg.tie_embeddings:
            w = params["embed"]["tok"]
            out = x.to(ldt) @ w.to(ldt).T
        else:
            out = x.to(ldt) @ params["lm_head"].to(ldt)
        return constrain(out, "logits")

    def _encode(self, params, frames, cdt):
        """The encoder over precomputed frames (B, Te, D): non-causal
        attention blocks, then the encoder's final norm."""
        x = constrain(frames.to(cdt), "hidden")
        pos = torch.arange(x.shape[1], device=x.device)
        x, _, _ = run_stack(self.cfg, self.run, params["encoder"]["layers"],
                            x, "train", positions=pos, is_encoder=True)
        return rms_norm(x, params["encoder"]["final_norm"], self.cfg.norm_eps)

    def _hidden(self, params, batch, mode):
        """The decoder stack's final-normed hidden states: vision patches
        (B, num_patches, D) prepended to the token embeddings, and an
        encoder-decoder's memory encoded from ``batch["frames"]``."""
        cfg, run = self.cfg, self.run
        cdt = _dt(run.precision.compute)
        x = self._embed(params, batch["tokens"], cdt)
        memory = None
        if cfg.frontend.kind == "vision":
            x = torch.cat([batch["patches"].to(device=x.device, dtype=cdt),
                           x], dim=1)
        if cfg.is_encoder_decoder:
            memory = self._encode(params, batch["frames"].to(x.device), cdt)
        x = constrain(x, "hidden")
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux, cache = run_stack(cfg, run, params["decoder"]["layers"], x,
                                  mode, positions=positions, memory=memory)
        x = rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)
        return x, aux, cache

    # -- forward (train / prefill) -------------------------------------------
    def forward(self, params, batch, mode="train"):
        x, aux, cache = self._hidden(params, batch, mode)
        return self._logits(params, x), aux, cache

    # -- loss ------------------------------------------------------------------
    def loss(self, params, batch):
        """Mean next-token cross-entropy over valid labels (>= 0), on the
        text positions only (a vision model's patch rows are cut), plus
        the aux losses summed over the stack; returns (loss, metrics) with
        metrics ``loss``, ``ce``, ``ntok`` and the aux terms, each a 0-d
        tensor. The padded vocab tail is masked out of the logsumexp. The
        gold logit is a ``gather``: JAX's one-hot sum adds only zeros
        beside that one logit, so both give the same value (and
        gradient)."""
        cfg = self.cfg
        logits, aux, _ = self.forward(params, batch, mode="train")
        if cfg.frontend.kind == "vision":          # text positions only
            logits = logits[:, cfg.frontend.num_patches:]
        labels = batch["labels"].to(torch.int64)
        Vp = logits.shape[-1]
        vmask = torch.arange(Vp, device=logits.device) < cfg.vocab_size
        logits = logits.masked_fill(~vmask, NEG_LOGIT)
        valid = labels >= 0
        safe = labels.clamp(0, cfg.vocab_size - 1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = settle(logits.gather(-1, safe[..., None]))[..., 0]
        ce = torch.where(valid, lse - gold, torch.zeros_like(lse))
        ntok = valid.sum().clamp(min=1).to(torch.int32)
        ce_mean = ce.sum() / ntok
        aux = {k: torch.as_tensor(v, dtype=torch.float32,
                                  device=logits.device)
               for k, v in aux.items()}
        loss = ce_mean + sum(aux.values())
        return loss, {"loss": loss, "ce": ce_mean, "ntok": ntok, **aux}

    # -- serving -------------------------------------------------------------
    def prefill(self, params, batch):
        """Returns (cache, last_logits). Only the last position's logits
        are computed: they are all the serve path reads. ``batch`` holds
        ``tokens`` (B, S), and ``patches`` (vision) or ``frames``
        (encoder-decoder) as ``input_specs`` lists them."""
        x, _, cache = self._hidden(params, batch, "prefill")
        return cache, self._logits(params, x[:, -1:])[:, 0]

    def prefill_chunk(self, params, cache, tokens, offset):
        """One chunk of a chunked prefill: process ``tokens`` (B,C) at
        absolute positions [offset, offset+C), appending KV into the dense
        staging ``cache`` (in place) and attending causally against every
        earlier chunk. ``offset`` is a 0-d int tensor. Returns (cache,
        logits (B,C,V)) — the caller picks the logits row of the last
        REAL token (trailing chunk padding yields garbage rows that are
        never used, and the padded KV tail is never attended).

        Only decoder-only all-attention stacks support this (recurrent
        blocks would need their chunk-boundary state threaded, and a
        decoder's cross attention has no memory here; the JAX method
        fails on either); the engine also leaves vision models out, whose
        patches a chunk does not carry."""
        cfg, run = self.cfg, self.run
        if (any(kind != ATTN for kind in cfg.block_pattern)
                or cfg.is_encoder_decoder):
            raise ValueError(f"{cfg.name}: chunked prefill needs a "
                             "decoder-only all-attention stack")
        offset = torch.as_tensor(offset, dtype=torch.int64)
        x = constrain(self._embed(params, tokens, _dt(run.precision.compute)),
                      "hidden")
        offset = offset.to(x.device)
        positions = offset + torch.arange(x.shape[1], device=x.device)
        x, _, cache = run_stack(cfg, run, params["decoder"]["layers"], x,
                                "prefill_chunk", cache=cache,
                                positions=positions, pos=offset)
        x = rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)
        return cache, self._logits(params, x)

    def decode_step(self, params, cache, tokens, pos, *, tables=None,
                    active=None):
        """tokens: (B,1) int; pos: the position the new token occupies
        (attends to <= pos). Returns (logits (B,V), cache), the cache
        updated in place.

        Two layouts. With ``tables`` ((B,NP) int32 paged-KV block
        tables), attention-cache leaves are page pools (nper, P, page,
        K, hd) — see ``repro_torch.serve.paged`` — and ``pos`` is (B,)
        int32, per slot. Without, the cache is ``init_cache``'s dense one
        and ``pos`` either one position for the whole batch (an int or a
        0-d tensor: ``flash_decode``) or (B,) per slot (the dense ring of
        continuous batching: the plain attention, as in JAX).

        active: optional (B,) bool — False rows are masked OUT of the
        decode: their KV rows stay bit-untouched (paged: the write goes to
        the garbage page 0; dense ring: the slot writes back the bytes it
        holds), their attention reads zero tokens (pos[b] must be < 0 for
        them) and their recurrent state stays bit-untouched. Their logits
        are garbage and must be discarded."""
        cfg, run = self.cfg, self.run
        x = constrain(self._embed(params, tokens, _dt(run.precision.compute)),
                      "hidden")
        if isinstance(pos, torch.Tensor) and pos.dim() == 1:
            # per-slot positions (paged, or the dense ring): rope positions
            # must be in-range even for inactive (-1) slots
            pos = pos.to(x.device)
            positions = pos.to(torch.int64).clamp(min=0)[:, None]
        elif isinstance(pos, torch.Tensor):
            pos = pos.to(x.device)
            positions = pos.reshape(1).to(torch.int64)
        else:
            # an int stays an int down to the cache write and the kernel
            # (an argument, not a tensor)
            pos = int(pos)
            positions = self._positions(pos, x.device)
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

    # -- specs and caches --------------------------------------------------
    def input_specs(self, shape: Optional[ShapeConfig] = None) -> dict:
        """The inputs of one step as ShapeDtype: tokens (and labels to
        train), vision patches (B, num_patches, D) and encoder frames (B,
        S // frame_ratio, D) in the compute dtype; a decode step's one
        token and its position."""
        cfg = self.cfg
        shape = shape or self.run.shape
        B, S = shape.global_batch, shape.seq_len
        cdt = _dt(self.run.precision.compute)
        i32 = torch.int32
        sd = P.ShapeDtype
        if shape.kind == "train":
            specs = {"tokens": sd((B, S), i32), "labels": sd((B, S), i32)}
        elif shape.kind == "prefill":
            specs = {"tokens": sd((B, S), i32)}
        else:  # decode: one new token against a cache of length S
            return {"tokens": sd((B, 1), i32), "pos": sd((), i32)}
        if cfg.frontend.kind == "vision":
            specs["patches"] = sd((B, cfg.frontend.num_patches, cfg.d_model),
                                  cdt)
        if cfg.is_encoder_decoder:
            Te = S // cfg.frontend.frame_ratio
            specs["frames"] = sd((B, Te, cfg.d_model), cdt)
        return specs

    def cache_specs(self, shape: Optional[ShapeConfig] = None) -> dict:
        """Dense decode-cache leaves as ShapeDtype, (periods, B, ...) per
        block: k, v (.., S, K, hd) for attention, and an encoder-decoder's
        cross xk, xv (.., S // frame_ratio, K, hd); for mamba the conv
        tail (.., conv-1, ch) in the compute dtype and the SSM state (..,
        heads, hd, N) in fp32; the mLSTM's C, n, m and the sLSTM's h, c,
        n, m in fp32."""
        cfg = self.cfg
        shape = shape or self.run.shape
        B, S = shape.global_batch, shape.seq_len
        cdt = _dt(self.run.precision.compute)
        nper = cfg.num_layers // len(cfg.block_pattern)
        K, hd, D = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
        f32 = torch.float32

        def sd(shp, dt=cdt):
            return P.ShapeDtype((nper,) + shp, dt)

        tree = {}
        for j, kind in enumerate(cfg.block_pattern):
            if kind == ATTN:
                c = {"k": sd((B, S, K, hd)), "v": sd((B, S, K, hd))}
                if cfg.is_encoder_decoder:
                    Te = S // cfg.frontend.frame_ratio
                    c["xk"] = sd((B, Te, K, hd))
                    c["xv"] = sd((B, Te, K, hd))
            elif kind == MAMBA:
                _, nh, _, ch = P.mamba_dims(cfg)
                c = {"conv": sd((B, cfg.ssm.conv_dim - 1, ch)),
                     "ssm": sd((B, nh, cfg.ssm.head_dim, cfg.ssm.d_state),
                               f32)}
            elif kind == MLSTM:
                _, nh = P.mlstm_dims(cfg)
                hdm = cfg.xlstm.head_dim
                c = {"mlstm": {"C": sd((B, nh, hdm, hdm), f32),
                               "n": sd((B, nh, hdm), f32),
                               "m": sd((B, nh), f32)}}
            else:                       # SLSTM
                c = {"slstm": {k_: sd((B, D), f32)
                               for k_ in ("h", "c", "n", "m")}}
            tree[f"block{j}"] = c
        return tree

    def init_cache(self, shape: Optional[ShapeConfig] = None,
                   device="cuda") -> dict:
        """Zeros, except the exp-gate stabilizers (every leaf named "m")
        at ``STATE_M0``, as in JAX."""
        dev = resolve_device(device)
        out = {}
        for path, s in tree_items(self.cache_specs(shape)):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            fill = STATE_M0 if path[-1] == "m" else 0.0
            node[path[-1]] = torch.full(s.shape, fill, dtype=s.dtype,
                                        device=dev)
        return out


def build_model(run: RunConfig) -> Model:
    return Model(run)
