"""Dry-run: count each (architecture x input-shape) cell's cost on the
``meta`` device (mirrors ``repro.launch.dryrun``).

For every cell, build the real step function (the train step, ``prefill``
or ``decode_step``) over tensors on the ``meta`` device, which carry shape
and dtype and no data, run it eagerly under a counting dispatch mode,
and fill a three-term ``Roofline`` for the production mesh, 16x16
single-pod and 2x16x16 multi-pod. The JAX package lowers and compiles
each cell against ``ShapeDtypeStruct`` inputs and reads XLA's cost
analysis and the partitioned HLO; PyTorch cannot lower a sharded step
without running it, so the port counts what its eager step issues:

- flops as XLA's cost analysis counts them: 2·M·N·K a matrix product
  (``torch.utils.flop_counter``'s formulas), one a pointwise op's output
  element, one a reduction's input element; transcendentals apart;
- bytes: each non-view op's tensor inputs and outputs, the eager traffic
  of the port (not XLA's fused "bytes accessed");
- collectives: ``collective_model``, a ring model of the sharding rules'
  all-gathers, all-reduces, reduce-scatters and all-to-alls;
- memory: argument and output bytes from the leaves' shards under the
  sharding rules, temp bytes the eager peak of live non-argument
  storages.

The trace is of the whole step on one (virtual) device: per-device flops
and bytes are the global counts over ``work_divisor``, the devices that
really split the work. Nothing is allocated and no card or process group
is touched; the mesh exists only as ``ShardingRules`` metadata.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import (ATTN, MLSTM, SHAPES, SLSTM,
                                      ShardingConfig, get_model_config,
                                      make_run_config, shape_applicable)
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import mesh_config
from repro_torch.models import xlstm
from repro_torch.models.model import _dt, build_model
from repro_torch.models.moe import GROUP_SIZE, capacity
from repro_torch.models.params import mlstm_dims, padded_vocab, slstm_dims
from repro_torch.runtime.hlo import CollectiveStats
from repro_torch.runtime.partitioning import P, ShardingRules
from repro_torch.runtime.roofline import (Roofline, mesh_peaks,
                                          model_flops_estimate)
from repro_torch.train.step import (batch_specs, make_train_step,
                                    train_state_shapes, train_state_specs)
from repro_torch.tree import tree_items, tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../results/dryrun_torch")

ASSIGNED_ARCHS = [
    "arctic-480b", "olmoe-1b-7b", "qwen3-0.6b", "llama3-8b", "deepseek-67b",
    "phi3-mini-3.8b", "seamless-m4t-medium", "xlstm-350m",
    "jamba-1.5-large-398b", "internvl2-1b",
]

#: what each count means, written into every cell's JSON
COUNT_NOTES = {
    "flops": "per device: the eager step's global count over `divisor`; "
             "2*M*N*K a matrix product, 1 a pointwise output element, 1 a "
             "reduction input element; transcendentals apart",
    "bytes": "per device: each non-view aten op's tensor inputs and "
             "outputs (the port's eager traffic), not XLA's fused bytes "
             "accessed",
    "collectives": "per device, at the compute dtype: collective_model's "
                   "ring model of the sharding rules (no term for the "
                   "seq mode's re-layouts of q, k and v)",
    "temp_bytes": "the eager peak of live non-argument storages over "
                  "`divisor` (allocations included; a storage lives while "
                  "any view of it does), not XLA's buffer assignment, nor "
                  "the caching allocator's rounding and workspaces",
    "peak_ici_bw": "NVLink inside one node of 8 cards, else the "
                   "inter-node rate a card (runtime.roofline.mesh_peaks)",
    "rows": "a mesh of more than one card is a model, not a measurement",
}


def _cell_path(arch, shape, mesh_name, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")


# ---------------------------------------------------------------------------
# the count
# ---------------------------------------------------------------------------
aten = torch.ops.aten
#: ops that move no bytes, compute nothing and make no memory (metadata)
_FREE = {aten.detach, aten._unsafe_view, aten.lift_fresh, aten.alias,
         aten.set_, aten.resize_}
#: ops that only allocate: live memory, no flops and no bytes
_ALLOC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
#: in-place ops that write their first argument without reading it
_WRITE_SELF = {aten.copy_, aten.fill_, aten.zero_}
#: in-place ops that write only part of their first argument
_SCATTER_SELF = {aten.index_copy_, aten.index_put_, aten._index_put_impl_,
                 aten.scatter_, aten.scatter_add_, aten.scatter_reduce_,
                 aten.index_add_, aten.masked_scatter_, aten.index_fill_}
#: ops that read only the rows their indices name
_GATHER = {aten.embedding, aten.index_select, aten.gather, aten.index,
           aten.take}
#: (flops, transcendentals) per output element of pointwise ops that are
#: not one flop each (XLA counts exp, log, logistic, rsqrt, tanh, ... as
#: transcendentals, not flops)
_POINTWISE = {
    **{op: (0, 1) for op in (
        aten.exp, aten.exp2, aten.expm1, aten.log, aten.log2, aten.log10,
        aten.log1p, aten.sqrt, aten.rsqrt, aten.tanh, aten.sigmoid,
        aten.sin, aten.cos, aten.tan, aten.erf, aten.erfc, aten.erfinv,
        aten.atan, aten.atan2, aten.asin, aten.acos, aten.sinh, aten.cosh)},
    aten.silu: (1, 1), aten.silu_backward: (4, 1),
    aten.log_sigmoid_forward: (2, 2), aten.log_sigmoid_backward: (3, 1),
    aten.sigmoid_backward: (2, 0), aten.tanh_backward: (2, 0),
    aten.clone: (0, 0),
}
#: (flops, transcendentals) per input element of the fused reductions
_REDUCTIONS = {aten._softmax: (4, 1), aten._log_softmax: (4, 1),
               aten._softmax_backward_data: (4, 0),
               aten._log_softmax_backward_data: (3, 1),
               aten.logsumexp: (3, 1), aten.cumsum: (1, 0)}


def _tagged(func, tag) -> bool:
    """``func`` carries ``tag``, or its out-of-place twin does (``add_`` is
    tagged pointwise, ``masked_fill_`` is not)."""
    if tag in func.tags:
        return True
    name = func.overloadpacket.__name__
    if not name.endswith("_"):
        return False
    twin = getattr(aten, name[:-1], None)
    ov = getattr(twin, func._overloadname, None) if twin else None
    return ov is not None and tag in ov.tags


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts flops, transcendentals, bytes and the live-memory peak of
    every aten op dispatched in its scope (global counts), and the work
    of the hand kernels that ``_kernel_path`` reports to ``kernel``.
    ``devices`` holds every device type it saw, ``off_meta`` the ops that
    saw another device than meta; host buffers (an allocation on the
    CPU) and host constants copied to the device are not counted, the
    constants' bytes go to ``host_constants``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.host_constants = 0
        self.devices: set = set()
        self.off_meta: set = set()
        self.kernels: dict = {}
        self.kernel_bytes: dict = {}
        self._storages: dict = {}    # storage -> [bytes, tensors alive]

    def kernel(self, name: str, flops: float, nbytes: float):
        self.flops += flops
        self.bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self.kernel_bytes[name] = self.kernel_bytes.get(name, 0) + nbytes

    def _release(self, key):
        held = self._storages[key]
        held[1] -= 1
        if held[1] == 0:
            self.live -= held[0]
            del self._storages[key]

    def _hold(self, outs, ins, fresh: bool = True):
        """Live memory by storage: a fresh output's storage is live until
        the last tensor on it dies (a view keeps its base's storage, as
        on the card); an input's storage is not the mode's to count, nor
        is a view's (``fresh`` False) whose base the mode did not see
        made."""
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            key = t.untyped_storage()._cdata
            if key not in self._storages:
                if not fresh or key in in_keys:
                    continue
                self._storages[key] = [t.untyped_storage().nbytes(), 0]
                self.live += self._storages[key][0]
                self.peak = max(self.peak, self.live)
            self._storages[key][1] += 1
            weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in _pt_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in _pt_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func.overloadpacket
        if (packet is aten._to_copy and ins[0].device.type == "cpu"
                and outs[0].device.type == "meta"):
            # a host constant put on the device (the rope table, made once
            # with numpy and cached a device): a literal, as in XLA
            self.host_constants += _nbytes(ins[0])
            return out
        if packet in _ALLOC and outs[0].device.type == "cpu":
            return out           # a host buffer (filled on the host)
        if func.is_view or packet in _FREE:
            self._hold(outs, ins, fresh=False)   # aliases of a storage
            return out
        for t in ins + outs:
            self.devices.add(t.device.type)
            if t.device.type != "meta":
                self.off_meta.add(str(func))
        self.ops += 1
        if packet not in _ALLOC:
            self._count_flops(func, packet, args, kwargs, ins, outs, out)
            self._count_bytes(packet, ins, outs)
        self._hold(outs, ins)
        return out

    def _count_flops(self, func, packet, args, kwargs, ins, outs, out):
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            return
        if packet in _REDUCTIONS:
            f, tr = _REDUCTIONS[packet]
            n = ins[0].numel()
        elif packet in (aten._to_copy, aten.copy_):
            src = ins[-1] if packet is aten.copy_ else ins[0]
            f, tr = (1, 0) if src.dtype != outs[0].dtype else (0, 0)
            n = outs[0].numel()
        elif packet is aten.pow and not isinstance(args[1], torch.Tensor):
            e = args[1]
            f, tr = ((e - 1, 0) if float(e).is_integer() and 1 <= e <= 4
                     else (0, 1))
            n = outs[0].numel()
        elif packet in _POINTWISE:
            f, tr = _POINTWISE[packet]
            n = outs[0].numel()
        elif _tagged(func, torch.Tag.pointwise):
            f, tr = 1, 0
            n = outs[0].numel()
        elif _tagged(func, torch.Tag.reduction):
            f, tr = 1, 0
            n = ins[0].numel()
        else:
            return
        self.flops += f * n
        self.transcendentals += tr * n

    def _count_bytes(self, packet, ins, outs):
        if packet in _WRITE_SELF:
            self.bytes += sum(_nbytes(t) for t in ins[1:]) + _nbytes(ins[0])
        elif packet in _SCATTER_SELF:
            self.bytes += 2 * sum(_nbytes(t) for t in ins[1:])
        elif packet in _GATHER:
            idx = [t for t in ins if not t.is_floating_point()]
            self.bytes += (sum(_nbytes(t) for t in idx)
                           + 2 * sum(_nbytes(t) for t in outs))
        else:
            self.bytes += (sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))


# ---------------------------------------------------------------------------
# the collective model, the work divisor and the shards
# ---------------------------------------------------------------------------
def _shards(rules: ShardingRules, spec) -> int:
    return math.prod(rules._size(e) for e in spec)


def work_divisor(run, rules: ShardingRules) -> int:
    """The devices that really split a step's work: the batch's fit over
    the data axes, times the model axis. The model axis splits every
    projection's weights (the ``%M`` param rules) and the attention in
    either mode: its heads (``"heads"``) or its query rows and the cache's
    sequence (``"seq"``, where kv heads do not divide it). Work on a
    replicated dimension is not divided."""
    return (rules._size(rules._fit(run.shape.global_batch, rules.dp_axes))
            * rules._size(rules.model_axis))


def collective_model(run, rules: ShardingRules, kind: str) -> CollectiveStats:
    """First-order ring model of one step's collectives, per device, at the
    compute dtype (cb bytes an element). With the batch split b ways over
    the data axes (``_fit``), m the model axis, B_l = B / b local rows,
    S the step's tokens a row (1 in decode), D the width:

      all-reduce (tensor parallel), m > 1: B_l*S*D*cb after each
        row-parallel projection (attention/cross ``wo``, mamba
        ``out_proj``, mLSTM ``w_out``, sLSTM ``up_wo``, a dense FFN's or
        an MoE's dense residual's ``wo``) and after the vocab-split
        embedding lookup; in training x3 each (forward, remat replay, the
        backward of the column-parallel input) and once more for the
        head's input gradient, plus 2*B_l*S*4 for the loss's max and sum
        over the split vocabulary
      all-reduce (decode over a sequence-split cache): B_l*H*(hd+2)*4 an
        attention layer (partial outputs and their max and sum, fp32)
      all-to-all (prefill, heads-split attention into a sequence-split
        cache): 2*B_l*S*(K/m)*hd*cb an attention layer (k and v; an
        encoder-decoder's cross k, v over its Te rows likewise)
      all-to-all (MoE, experts over m): E*G_l*C*D*cb/m for the dispatch
        and again for the combine of each MoE layer (G_l local groups,
        C slots); x3 in training
      all-gather (FSDP): numel/model_shards*cb for each param leaf split
        over the fsdp axes; x2 in training (forward, remat replay)
      reduce-scatter (training): the same bytes, each fsdp-split leaf's
        gradient; all-reduce (training): numel/model_shards*cb for each
        leaf replicated over the data axes (b > 1)
    """
    cfg, sh = run.model, run.sharding
    cb = _dt(run.precision.compute).itemsize
    shape = run.shape
    B = shape.global_batch
    b = rules._size(rules._fit(B, rules.dp_axes))
    m = rules._size(rules.model_axis)
    Bl = B // b
    S = 1 if kind == "decode" else shape.seq_len
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    train = kind == "train"
    passes = (3 if sh.remat != "none" else 2) if train else 1
    stats = CollectiveStats()

    def add(op, nbytes, n=1):
        if nbytes > 0 and n > 0:
            stats.bytes_by_op[op] += int(nbytes * n)
            stats.count_by_op[op] += n

    Te = S // cfg.frontend.frame_ratio if cfg.is_encoder_decoder else 0
    if m > 1:
        row_proj = 0
        for i in range(cfg.num_layers):
            kind_i = cfg.layer_kind(i)
            row_proj += 1 + int(kind_i == ATTN and cfg.is_encoder_decoder)
            moe = cfg.layer_has_moe(i)
            row_proj += int(cfg.d_ff > 0 and (not moe or
                                              cfg.moe.dense_residual))
        act = Bl * S * D * cb
        add("all-reduce", act, row_proj * passes + 1 + int(train))
        if cfg.num_encoder_layers and kind != "decode":
            # encoder blocks: attention wo and the FFN's wo
            enc = cfg.num_encoder_layers * (1 + int(cfg.d_ff > 0))
            add("all-reduce", Bl * Te * D * cb, enc * passes)
        if train:
            add("all-reduce", 2 * Bl * S * 4)
        n_attn = sum(cfg.layer_kind(i) == ATTN for i in range(cfg.num_layers))
        seq_cache = rules.spec("kv_cache", (B, shape.seq_len, K, hd))[1]
        if kind == "decode" and seq_cache is not None:
            add("all-reduce", Bl * H * (hd + 2) * 4, n_attn)
        if (kind == "prefill" and seq_cache is not None
                and rules.attn_mode(H) == "heads"):
            add("all-to-all", 2 * Bl * S * (K // m) * hd * cb, n_attn)
            if cfg.is_encoder_decoder:
                add("all-to-all", 2 * Bl * Te * (K // m) * hd * cb, n_attn)
        if cfg.moe is not None and rules._fit(cfg.moe.num_experts, ("model",)):
            sg = min(GROUP_SIZE, S)
            G = B * S // sg
            Gl = G // rules._size(rules._fit(G, rules.dp_axes))
            C = capacity(sg, cfg.moe)
            n_moe = sum(cfg.layer_has_moe(i) for i in range(cfg.num_layers))
            add("all-to-all", cfg.moe.num_experts * Gl * C * D * cb / m,
                2 * n_moe * passes)

    pshapes = build_model(run).param_shapes()
    for path, leaf in tree_items(pshapes):
        spec = rules.param_spec("/".join(path), leaf.shape)
        fsdp = any(e is not None and set((e,) if isinstance(e, str) else e)
                   & set(rules.fsdp_axes) for e in spec)
        model_sh = math.prod(rules._size(e) for e in spec
                             if e is not None and not (
                                 set((e,) if isinstance(e, str) else e)
                                 & set(rules.fsdp_axes)))
        nb = math.prod(leaf.shape) / model_sh * cb
        if fsdp:
            add("all-gather", nb, 2 if train else 1)
            if train:
                add("reduce-scatter", nb)
        elif train and b > 1:
            add("all-reduce", nb)
    return stats


def cache_partition_specs(rules: ShardingRules, cache_shapes):
    """Decode-cache specs: kv leaves get the kv_cache rule (seq sharding),
    recurrent states shard on batch. Leading dim is the period stack."""
    out = {}
    for path, leaf in tree_items(cache_shapes):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        kind = "kv_cache" if path[-1] in ("k", "v", "xk", "xv") else "state"
        node[path[-1]] = P(None, *rules.spec(kind, tuple(leaf.shape[1:])))
    return out


def _sharded_bytes(rules, tree, specs) -> int:
    """Per-device bytes of a tree's leaves under their specs."""
    total = 0
    for (_, leaf), (_, spec) in zip(tree_items(tree), tree_items(specs)):
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // _shards(
            rules, spec)
    return total


# ---------------------------------------------------------------------------
# building a cell
# ---------------------------------------------------------------------------
def _meta(tree):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


@dataclasses.dataclass
class MetaStep:
    """One cell's step over meta tensors: the counterpart of JAX's
    ``Lowered``. ``call()`` runs the step; ``memory`` holds argument and
    output bytes per device under the sharding rules."""
    fn: object
    kind: str
    run: object
    rules: ShardingRules
    memory: dict

    def call(self):
        with (torch.no_grad() if self.kind != "train"
              else contextlib.nullcontext()):
            return self.fn()


def _logits_bytes(run, rules) -> int:
    """A serving step's last-position logits (B, padded V), fp32."""
    B, V = run.shape.global_batch, padded_vocab(run.model)
    return B * V * 4 // _shards(rules, rules.spec("logits", (B, V)))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None, model_override=None, *,
               shape=None, mesh=None):
    """Build one cell on the meta device; returns (step, run, rules).
    ``shape`` (a ``ShapeConfig``) and ``mesh`` (a ``MeshConfig``) replace
    ``SHAPES[shape_name]`` and the production mesh."""
    mcfg = mesh if mesh is not None else mesh_config(multi_pod=multi_pod)
    kw = {"kernel_backend": "reference", **(overrides or {})}
    run = make_run_config(arch, shape if shape is not None else shape_name,
                          mesh=mcfg, **kw)
    if model_override is not None:
        run = dataclasses.replace(run, model=model_override)
    model = build_model(run)
    rules = ShardingRules(mcfg, run, mesh=None)
    kind = run.shape.kind
    pshapes = model.param_shapes()
    pspecs = rules.param_specs(pshapes)
    bshapes = model.input_specs()
    if kind == "train":
        state = train_state_shapes(run)
        batch = _meta(bshapes)
        sspecs = train_state_specs(run, rules)
        state_b = _sharded_bytes(rules, state, sspecs)
        arg = state_b + _sharded_bytes(rules, bshapes, batch_specs(run,
                                                                   rules))
        step = make_train_step(run)
        # the new state's leaves and ~10 fp32 metrics
        memory = {"argument_bytes": arg, "output_bytes": state_b + 40}

        def fn():
            return step(state, batch)
    elif kind == "prefill":
        params = _meta(pshapes)
        batch = _meta(bshapes)
        arg = (_sharded_bytes(rules, pshapes, pspecs)
               + _sharded_bytes(rules, bshapes, batch_specs(run, rules)))
        cshapes = model.cache_specs()
        memory = {"argument_bytes": arg, "output_bytes": _sharded_bytes(
            rules, cshapes, cache_partition_specs(rules, cshapes))
            + _logits_bytes(run, rules)}

        def fn():
            return model.prefill(params, batch)
    else:  # decode
        params = _meta(pshapes)
        cshapes = model.cache_specs()
        cache = _meta(cshapes)
        B = run.shape.global_batch
        tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
        cache_b = _sharded_bytes(rules, cshapes,
                                 cache_partition_specs(rules, cshapes))
        tok_b = B * 4 // rules._size(rules._fit(B, rules.dp_axes))
        arg = _sharded_bytes(rules, pshapes, pspecs) + cache_b + tok_b + 4
        memory = {"argument_bytes": arg,
                  "output_bytes": cache_b + _logits_bytes(run, rules)}
        pos = run.shape.seq_len - 1      # the cache's last row, a scalar

        def fn():
            return model.decode_step(params, cache, tokens, pos)
    return MetaStep(fn, kind, run, rules, memory), run, rules


# ---------------------------------------------------------------------------
# True-cost extraction.
#
# The eager trace counts every layer, so one trace at full depth is the
# cell's cost. Like the JAX package, the port still traces two variants
# with P=1 and P=2 pattern-periods and extrapolates (every metric is
# linear in P: metric = a + b*P, so b = m2 - m1, a = m1 - b, total =
# a + nper*b): a deep stack (jamba's 72 layers, 9 periods) then traces 3
# periods, not 9.
#
# xLSTM blocks run inner time loops (the mLSTM chunk loop, the sLSTM token
# loop) in Python; traced in full, a 4,096-token sLSTM with its backward
# takes minutes. The count runs their first trip only (``_first_trips``),
# as XLA counts a while body once, and adds the missing trips
# analytically (``_inner_scan_correction``, the JAX package's formulas).
# ---------------------------------------------------------------------------
def _inner_scan_correction(model_cfg, shape_cfg, kind: str) -> dict:
    """Analytic add-on flops/bytes for inner time scans (xlstm only)."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    if kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    mult = 4.0 if kind == "train" else 1.0      # fwd + remat replay + 2x bwd
    plen = len(model_cfg.block_pattern)
    nper = model_cfg.num_layers // plen
    flops = 0.0
    for j, bk in enumerate(model_cfg.block_pattern):
        if bk == MLSTM:
            di, H = mlstm_dims(model_cfg)
            hd = model_cfg.xlstm.head_dim
            Q = min(model_cfg.xlstm.chunk, S)
            nc = S // Q
            body = B * H * (4 * Q * Q * hd + 8 * Q * hd * hd)
            flops += (nc - 1) * body * mult * nper
        elif bk == SLSTM:
            heads, dh, d_up = slstm_dims(model_cfg)
            D = model_cfg.d_model
            body = B * (8 * D * D + 8 * D * dh + 20 * D)
            flops += (S - 1) * body * mult * nper
    return {"flops": flops, "bytes": flops / 16.0}  # ~AI of these blocks


@contextlib.contextmanager
def _first_trips():
    """Within this scope the xLSTM inner loops run their first trip (one
    chunk, one token) and repeat its output to the sequence's length."""
    chunked, scan = xlstm.mlstm_chunked, xlstm.slstm_scan

    def one_chunk(q, k, v, log_f, log_i, state=None, chunk: int = 128):
        S = q.shape[1]
        Q = xlstm.check_mlstm_chunk(S, chunk)
        h, st = chunked(q[:, :Q], k[:, :Q], v[:, :Q], log_f[:, :Q],
                        log_i[:, :Q], state, chunk)
        return h.repeat(1, S // Q, 1, 1), st

    def one_token(zx, ix, fx, ox, r, bias, state):
        y, st = scan(zx[:, :1], ix[:, :1], fx[:, :1], ox[:, :1], r, bias,
                     state)
        return y.repeat(1, zx.shape[1], 1), st

    xlstm.mlstm_chunked, xlstm.slstm_scan = one_chunk, one_token
    try:
        yield
    finally:
        xlstm.mlstm_chunked, xlstm.slstm_scan = chunked, scan


@contextlib.contextmanager
def _kernel_path(mode: CostMode):
    """Within this scope ``flash_attention`` and ``flash_decode`` called
    on the kernel path (``backend="auto"``) with meta tensors check their
    arguments as the wrapper does before a launch, report their kernel's
    work to ``mode.kernel`` and return the output's shape: no launch, no
    launch count. Flops are 4*hd a (query head, key) pair, bytes each
    input read once and each output written once, at the inputs' width
    (bf16 2 bytes, fp32 4: the kernels take either)."""
    fa, fd = kops.flash_attention, kops.flash_decode

    def flash_attention(q, k, v, *, causal: bool = True,
                        backend: str = "auto"):
        if backend != "auto" or q.device.type != "meta":
            return fa(q, k, v, causal=causal, backend=backend)
        kops.check_flash_attention(q, k, v)
        B, S, H, hd = q.shape
        T = k.shape[1]
        m = min(S, T)    # query i sees keys j <= i (top-left aligned)
        pairs = m * (m + 1) // 2 + (S - m) * T if causal else S * T
        mode.kernel("flash_attention", 4 * B * H * hd * pairs,
                    2 * _nbytes(q) + _nbytes(k) + _nbytes(v))
        return torch.empty_like(q)

    def flash_decode(q, k, v, pos, *, backend: str = "auto"):
        if backend != "auto" or q.device.type != "meta":
            return fd(q, k, v, pos, backend=backend)
        kops.check_decode_call(k, pos)
        kops.check_flash_decode(q, k, v)
        B, _, H, hd = q.shape
        T, K = k.shape[1], k.shape[2]
        # the cache rows the kernel reads: <= pos (a tensor's value is
        # unknown on meta: every row)
        n = T if isinstance(pos, torch.Tensor) else max(0, min(pos, T - 1) + 1)
        mode.kernel("flash_decode", 4 * B * H * hd * n,
                    2 * _nbytes(q) + 2 * B * n * K * hd * k.element_size())
        return torch.empty_like(q)

    kops.flash_attention, kops.flash_decode = flash_attention, flash_decode
    try:
        yield
    finally:
        kops.flash_attention, kops.flash_decode = fa, fd


def _cost_of(lowered) -> dict:
    """One cell's per-device costs: the step traced under ``CostMode``
    over ``work_divisor``, and ``collective_model``'s bytes."""
    mode = CostMode()
    with _first_trips(), _kernel_path(mode), mode:
        lowered.call()
    d = work_divisor(lowered.run, lowered.rules)
    coll = collective_model(lowered.run, lowered.rules, lowered.kind)
    return {"flops": mode.flops / d,
            "transcendentals": mode.transcendentals / d,
            "bytes": mode.bytes / d,
            "temp_bytes": mode.peak / d,
            "coll_bytes": float(coll.total_bytes),
            "coll_by_op": dict(coll.bytes_by_op),
            "devices": sorted(mode.devices),
            "off_meta": sorted(mode.off_meta),
            "kernels": dict(mode.kernels),
            "kernel_bytes": dict(mode.kernel_bytes)}


_LINEAR = ("flops", "transcendentals", "bytes", "temp_bytes", "coll_bytes")


def true_costs(arch: str, shape_name: str, multi_pod: bool, run,
               overrides: dict | None = None) -> dict:
    """Extrapolated per-device costs for the full layer count."""
    base = run.model
    plen = len(base.block_pattern)
    nper = base.num_layers // plen
    var_overrides = dict(overrides or {})
    var_overrides.setdefault("sharding", run.sharding)
    var_overrides["precision"] = run.precision
    var_overrides["optimizer"] = run.optimizer
    ms = []
    for P_ in (1, 2):
        mc = dataclasses.replace(
            base, num_layers=plen * P_,
            num_encoder_layers=(plen * P_ if base.num_encoder_layers else 0))
        lowered, _, _ = lower_cell(arch, shape_name, multi_pod,
                                   overrides=var_overrides,
                                   model_override=mc, shape=run.shape,
                                   mesh=run.mesh)
        ms.append(_cost_of(lowered))
    out = {}
    for key in _LINEAR:
        b = ms[1][key] - ms[0][key]
        a = ms[0][key] - b
        out[key] = max(a + nper * b, 0.0)
    by_op = {}
    for op in set(ms[0]["coll_by_op"]) | set(ms[1]["coll_by_op"]):
        b = ms[1]["coll_by_op"].get(op, 0) - ms[0]["coll_by_op"].get(op, 0)
        a = ms[0]["coll_by_op"].get(op, 0) - b
        v = a + nper * b
        if v > 0:
            by_op[op] = v
    out["coll_by_op"] = by_op
    out["kernels"] = {}                  # the hand kernels' calls a step
    for k in set(ms[0]["kernels"]) | set(ms[1]["kernels"]):
        b = ms[1]["kernels"].get(k, 0) - ms[0]["kernels"].get(k, 0)
        out["kernels"][k] = ms[0]["kernels"].get(k, 0) - b + nper * b
    out["devices"] = sorted(set(ms[0]["devices"]) | set(ms[1]["devices"]))
    out["off_meta"] = sorted(set(ms[0]["off_meta"]) | set(ms[1]["off_meta"]))
    corr = _inner_scan_correction(base, run.shape, run.shape.kind)
    d = work_divisor(run, ShardingRules(run.mesh, run, mesh=None))
    out["flops"] += corr["flops"] / d
    out["bytes"] += corr["bytes"] / d
    out["inner_scan_corr_flops"] = corr["flops"]
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, force: bool = False,
             tag: str = "", overrides: dict | None = None, *,
             shape=None, mesh=None) -> dict:
    """Count one cell and write its JSON (returned as a dict). ``shape``
    and ``mesh`` replace ``SHAPES[shape_name]`` and the production mesh;
    the mesh name is then its shape, e.g. ``1x1``."""
    mcfg = mesh if mesh is not None else mesh_config(multi_pod=multi_pod)
    shape_cfg = shape if shape is not None else SHAPES[shape_name]
    base = (("multi" if multi_pod else "single") if mesh is None
            else "x".join(str(n) for n in mcfg.shape))
    mesh_name = base + (f"-{tag}" if tag else "")
    path = _cell_path(arch, shape_name, mesh_name, out_dir)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    model_cfg = get_model_config(arch)
    ok, why = shape_applicable(model_cfg, shape_cfg)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "chips": mcfg.num_devices}
    if not ok:
        result.update({"status": "skipped", "reason": why})
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        return result

    try:
        overrides = dict(overrides or {})
        overrides.setdefault("sharding", ShardingConfig(remat="full"))

        t0 = time.perf_counter()
        lowered, run, rules = lower_cell(arch, shape_name, multi_pod,
                                         overrides, shape=shape_cfg,
                                         mesh=mcfg)
        t_lower = time.perf_counter() - t0

        t0 = time.perf_counter()
        tc = true_costs(arch, shape_name, multi_pod, run, overrides)
        t_trace = time.perf_counter() - t0
        if tc["devices"] != ["meta"]:
            raise RuntimeError(f"the count saw tensors on {tc['devices']} "
                               f"(ops {tc['off_meta']}): "
                               "a dry-run cell allocates nothing")
        coll = collective_model(run, rules, run.shape.kind)

        chips = result["chips"]
        rf = Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
            hlo_flops=tc["flops"],
            hlo_bytes=tc["bytes"],
            collective_bytes=tc["coll_bytes"],
            collective_detail={"bytes_by_op": tc["coll_by_op"]},
            model_flops=model_flops_estimate(run.model, run.shape),
            peaks=mesh_peaks(chips))

        result.update({
            "status": "ok",
            "lower_s": t_lower, "compile_s": t_trace,
            "memory": {**lowered.memory, "temp_bytes": tc["temp_bytes"],
                       "code_bytes": 0},
            "divisor": work_divisor(run, rules),
            "cost_extrapolated": {k: v for k, v in tc.items()
                                  if k not in ("coll_by_op", "devices",
                                               "off_meta")},
            "collectives_model": coll.describe(),
            "collectives": {"bytes_by_op": tc["coll_by_op"],
                            "total_bytes": sum(tc["coll_by_op"].values())},
            "count": COUNT_NOTES,
            "roofline": rf.row(),
        })
    except Exception as e:                                    # noqa: BLE001
        result.update({"status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]})
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="one shape (default: all four)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a in ASSIGNED_ARCHS:
            print(a)
        return 0

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = run_cell(arch, shape, mp, out_dir=args.out,
                             force=args.force)
                status = r["status"]
                line = f"{arch:24s} {shape:12s} {r['mesh']:7s} {status}"
                if status == "ok":
                    rf = r["roofline"]
                    line += (f"  bound={rf['bound']:10s}"
                             f" step={rf['step_s']*1e3:8.2f}ms"
                             f" trace={r['compile_s']:6.1f}s")
                    mb = (r['memory']['argument_bytes'] +
                          r['memory']['temp_bytes']) / 2**30
                    line += f" mem/dev={mb:7.2f}GiB"
                elif status == "error":
                    failures += 1
                    line += f"  {r['error'][:80]}"
                print(line, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
