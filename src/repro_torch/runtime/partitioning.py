"""Sharding rules and the activation constraint (mirrors
``repro.runtime.partitioning``).

The JAX package resolves logical activation kinds ("hidden", "logits",
...) and parameter paths to ``PartitionSpec``s for its meshes, with
divisibility fallbacks so that the same model runs on the unit mesh, the
single-pod 16x16 mesh and the multi-pod 2x16x16 mesh. The port keeps the
same rules and gives the same answers: a spec is a ``P``, a tuple whose
entries are ``None``, a mesh-axis name or a tuple of names, so
``tuple(p) == tuple(jax_spec)`` compares the two directly.

A VF whose devices are ranks of a ``core.ranks.RankPool`` carries a
``torch.distributed`` ``DeviceMesh``: its train state lives as DTensors
placed by these specs (``placements``, ``named``, ``place_tree``), and
``constrain`` lays an activation out as ``spec`` says with
``DTensor.redistribute``, where JAX calls ``with_sharding_constraint``.
``constrain`` is the identity with no scope, on the unit mesh, with
``mesh=None`` rules (layout metadata: the dry-run's meta trace, a pause
snapshot's ``sharding_desc``), on a plain tensor and for an unknown
kind, as JAX returns ``x``.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Optional

import torch

from repro_torch.configs.base import MeshConfig, RunConfig
from repro_torch.tree import tree_map

_TLS = threading.local()


class P(tuple):
    """A ``PartitionSpec``: one entry per tensor dim, ``None`` (replicated),
    a mesh-axis name, or a tuple of names (sharded over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):           # pickle / copy rebuild P(*entries)
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def current_rules() -> Optional["ShardingRules"]:
    return getattr(_TLS, "rules", None)


@contextlib.contextmanager
def sharding_scope(rules: Optional["ShardingRules"]):
    prev = getattr(_TLS, "rules", None)
    _TLS.rules = rules
    try:
        yield
    finally:
        _TLS.rules = prev


@contextlib.contextmanager
def spmd_scope(rules: Optional["ShardingRules"]):
    """``sharding_scope(rules)``; with a ``DeviceMesh`` in the rules also
    DTensor's implicit replication, so that a plain tensor made inside a
    step (a rope table, a mask, a learning rate) meets the sharded state
    as a replicated DTensor."""
    with sharding_scope(rules):
        if rules is None or rules.mesh is None:
            yield
            return
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        with implicit_replication():
            yield


def placements(spec, mesh_axes) -> tuple:
    """DTensor placements of ``spec`` on a mesh with dims ``mesh_axes``:
    per mesh dim, ``Shard(d)`` for the tensor dim ``d`` whose entry names
    that axis (alone or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                owner[ax] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh_axes)


class ShardingRules:
    """Resolves logical activation kinds and parameter paths to specs."""

    def __init__(self, mesh_cfg: MeshConfig, run_cfg: RunConfig, mesh=None):
        self.mesh_cfg = mesh_cfg
        self.run = run_cfg
        self.mesh = mesh                 # a DeviceMesh, or None (metadata)
        self.axis_size = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
        self.dp_axes = mesh_cfg.data_axes           # e.g. ("pod", "data")
        self.model_axis = "model" if "model" in mesh_cfg.axes else None
        self.fsdp_axes = self.dp_axes if run_cfg.sharding.fsdp else ()

    def attn_mode(self, num_heads=None) -> str:
        """'heads' when kv heads divide the model axis, else 'seq'."""
        kv = self.run.model.num_kv_heads
        m = self.axis_size.get("model", 1)
        if m <= 1:
            return "heads"
        if kv % m == 0 and (num_heads is None or num_heads % m == 0):
            return "heads"
        return "seq"

    # -- helpers -----------------------------------------------------------
    def _size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return int(math.prod(self.axis_size.get(a, 1) for a in axes))

    def _fit(self, dim: int, axes):
        """Return ``axes`` if ``dim`` is divisible by their product else None."""
        if not axes:
            return None
        sz = self._size(axes)
        if sz <= 1:
            return None
        if dim % sz != 0:
            return None
        if isinstance(axes, tuple) and len(axes) == 1:
            return axes[0]
        return axes

    def spec(self, kind: str, shape) -> P:
        """Activation spec by logical kind (``KeyError`` for an unknown
        kind, and for ``"hidden_full"`` outside SP mode, as in JAX)."""
        dp = tuple(self.dp_axes)
        mdl = self.model_axis
        mdl_ax = (mdl,) if mdl else ()
        sp_acts = self.run.sharding.seq_shard_acts
        if kind == "batch":          # (B, S) token ids
            return P(self._fit(shape[0], dp), None)
        if kind == "hidden":         # (B, S, D)
            sp = mdl if (sp_acts and mdl) else None
            return P(self._fit(shape[0], dp),
                     self._fit(shape[1], (sp,) if sp else ()), None)
        if kind == "hidden_full":    # (B, S, D) gathered for TP matmuls
            if not sp_acts:
                raise KeyError(kind)
            return P(self._fit(shape[0], dp), None, None)
        if kind == "logits":         # (B, S, V) or (B, V)
            if sp_acts and mdl and len(shape) == 3:
                # SP: sequence-sharded, vocab local (lm_head replicated)
                return P(self._fit(shape[0], dp),
                         self._fit(shape[1], (mdl,)), None)
            v_ax = self._fit(shape[-1], mdl_ax)
            if len(shape) == 3:
                return P(self._fit(shape[0], dp), None, v_ax)
            return P(self._fit(shape[0], dp), v_ax)
        if kind == "attn_q":         # (B, S, H, hd): heads-TP or seq-SP
            dpq = self._fit(shape[0], dp)
            if self.attn_mode(shape[2]) == "heads":
                return P(dpq, None, self._fit(shape[2], (mdl,)), None)
            return P(dpq, self._fit(shape[1], mdl_ax), None, None)
        if kind == "attn_kv":        # (B, T, K, hd)
            dpq = self._fit(shape[0], dp)
            if self.attn_mode(None) == "heads":
                return P(dpq, None, self._fit(shape[2], (mdl,)), None)
            return P(dpq, None, None, None)
        if kind == "kv_cache":       # (B, S, K, h) — decode cache
            b_ax = self._fit(shape[0], dp)
            if b_ax is None and self.run.sharding.shard_kv_seq:
                # batch too small (long_500k): sequence over everything
                all_ax = tuple(a for a in (*dp, mdl) if a)
                return P(None, self._fit(shape[1], all_ax), None, None)
            seq_ax = (self._fit(shape[1], mdl_ax)
                      if self.run.sharding.shard_kv_seq else None)
            return P(b_ax, seq_ax, None, None)
        if kind == "state":          # (B, ...) recurrent state
            return P(self._fit(shape[0], dp), *([None] * (len(shape) - 1)))
        if kind == "expert":         # (E, G, C, D) MoE expert inputs
            return P(self._fit(shape[0], mdl_ax),
                     self._fit(shape[1], dp), None, None)
        if kind == "moe_mask":       # (G, sg, E) routing one-hots
            return P(self._fit(shape[0], dp), None,
                     self._fit(shape[2], mdl_ax))
        if kind == "moe_counts":     # (G, E)
            return P(self._fit(shape[0], dp), self._fit(shape[1], mdl_ax))
        if kind == "moe_dispatch":   # (G, sg, E, C) dispatch/combine
            return P(self._fit(shape[0], dp), None,
                     self._fit(shape[2], mdl_ax), None)
        raise KeyError(kind)

    # -- parameters --------------------------------------------------------
    # Rules matched (first hit) against '/'-joined path suffixes. %F = fsdp
    # axes, %M = model axis. Specs are for the LOGICAL (unstacked) leaf;
    # period-stacked leaves get a leading None.
    PARAM_RULES = [
        (r"embed/tok$",            ("%M", None)),
        (r"lm_head$",              ("%F", "%M")),
        (r"(wq|wk|wv|xq|xk|xv)$",  ("%F", "%M")),
        (r"(wo|xo)$",              ("%M", "%F")),
        (r"ffn/(wi|wg)$",          ("%F", "%M")),
        (r"ffn/wo$",               ("%M", "%F")),
        (r"moe/router$",           (None, None)),
        (r"moe/(wi|wg)$",          ("%M", "%F", None)),
        (r"moe/wo$",               ("%M", None, "%F")),
        (r"in_proj$",              ("%F", "%M")),
        (r"out_proj$",             ("%M", "%F")),
        (r"conv_w$",               (None, "%M")),
        (r"conv_b$",               ("%M",)),
        (r"w_up$",                 ("%F", "%M")),
        (r"w_out$",                ("%M", "%F")),
        (r"(w_i|w_f)$",            ("%F", None)),
        (r"(w_z|w_o)$",            ("%F", "%M")),
        (r"(r_z|r_i|r_f|r_o)$",    (None, None, None)),
        (r"up_(wi|wg)$",           ("%F", "%M")),
        (r"up_wo$",                ("%M", "%F")),
    ]

    def param_spec(self, path: str, shape) -> P:
        stacked = "/layers/" in path           # period-stacked leaf
        logical = shape[1:] if stacked else shape
        spec: list = [None] * len(logical)
        if self.run.sharding.seq_shard_acts and re.search(r"lm_head$", path):
            # SP mode: lm_head vocab-replicated so logits stay seq-sharded
            return P(self._fit(logical[0], self.fsdp_axes), None)
        mdl_ax = (self.model_axis,) if self.model_axis else ()
        for pat, axes in self.PARAM_RULES:
            if re.search(pat, path):
                for i, a in enumerate(axes):
                    if a == "%F":
                        spec[i] = self._fit(logical[i], self.fsdp_axes)
                    elif a == "%M":
                        spec[i] = self._fit(logical[i], mdl_ax)
                break
        if stacked:
            spec = [None] + spec
        return P(*spec)

    def param_specs(self, tree) -> dict:
        """The spec of every leaf (anything with a ``shape``) of a nested
        dict, by its path joined with '/' as JAX's ``keystr(path,
        simple=True, separator="/")`` writes it."""
        def walk(node, prefix):
            return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict) else
                    self.param_spec(f"{prefix}{k}", tuple(v.shape))
                    for k, v in node.items()}
        return walk(tree, "")

    def named(self, spec_tree):
        """Each spec of ``spec_tree`` as DTensor placements on ``mesh``
        (pass them with ``rules.mesh`` to ``distribute_tensor``)."""
        if self.mesh is None:
            raise ValueError("ShardingRules.named needs a DeviceMesh "
                             "(these rules were built with mesh=None)")
        axes = self.mesh.mesh_dim_names
        return tree_map(lambda s: placements(s, axes), spec_tree)


def constrain(x, kind: str):
    """Lay ``x`` out as ``rules.spec(kind, x.shape)`` says when a scope
    with a ``DeviceMesh`` of more than one device is active and ``x`` is a
    DTensor (a redistribute: all-gather, reduce-scatter or a local chunk,
    as the move needs); else ``x`` itself, as in JAX."""
    rules = current_rules()
    if (rules is None or rules.mesh is None
            or rules.mesh_cfg.num_devices <= 1 or not is_dtensor(x)):
        return x
    try:
        spec = rules.spec(kind, tuple(x.shape))
    except KeyError:
        return x
    target = placements(spec, rules.mesh.mesh_dim_names)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(rules.mesh, target)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def settle(x):
    """``x`` with any pending (``Partial``) placement reduced to
    ``Replicate``; the identity on a plain tensor."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def local_shard(full, mesh, places):
    """This rank's block of ``full`` under ``places`` on ``mesh``: each
    ``Shard(d)`` splits dim ``d`` into equal parts in mesh-dim order (the
    specs shard only dims their axes divide) and keeps the part at this
    rank's coordinate. A contiguous copy: ``full`` may go."""
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(places):
        if p.is_shard():
            n = mesh.size(i)
            size = out.shape[p.dim] // n
            out = out.narrow(p.dim, coord[i] * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def place_tree(tree, mesh, places_tree):
    """A tree of full tensors (the same values on every member rank) as
    DTensors laid out by ``places_tree``: each rank keeps only its block,
    no collective runs."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x, pl: DTensor.from_local(
        local_shard(x, mesh, pl), mesh, pl, run_check=False),
        tree, places_tree)


def local_shape(shape, mesh, places) -> tuple:
    """The shape of this rank's block of a ``shape`` tensor."""
    out = list(shape)
    for i, p in enumerate(places):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def zeros_tree(shapes, mesh, places_tree, device):
    """DTensors of zeros laid out by ``places_tree``, shaped and typed as
    the (``meta``) tensors of ``shapes``: each rank allocates only its
    block."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda s, pl: DTensor.from_local(
        torch.zeros(local_shape(s.shape, mesh, pl), dtype=s.dtype,
                    device=device), mesh, pl, run_check=False),
        shapes, places_tree)


def gather_tree(tree):
    """A tree's DTensor leaves as full tensors on every member rank
    (plain leaves pass through)."""
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


# ---------------------------------------------------------------------------
# gloo collectives on a card's tensors
# ---------------------------------------------------------------------------
def gloo_card_collectives():
    """Route DTensor's collectives on a card's tensors over a gloo group
    through the synchronous ``torch.distributed`` calls.

    The ranks of one card share it under gloo (NCCL refuses two ranks on
    one device). gloo's synchronous collectives take CUDA tensors (and
    copy them through host memory); the functional collectives that
    DTensor calls (``all_gather_tensor`` / ``_single``,
    ``reduce_scatter_tensor`` / ``_single``, ``all_reduce``,
    ``all_to_all_single``) crash the process in ``wait_tensor`` on an
    H100 with torch 2.11. Each is wrapped here: a CUDA tensor over a
    gloo group takes ``_gloo_*`` below, anything else the original. A
    shard-to-shard move (an all-to-all in DTensor's custom op) becomes an
    all-gather and a local chunk, as DTensor moves it for gloo on the
    CPU. Idempotent; every process that computes on DTensors on a card
    calls it once."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt
    if getattr(funcol, "_gloo_card", False):
        return

    def gather(orig):
        def f(self, gather_dim, group, tag=""):
            pg = _gloo_card_group(self, group)
            if pg is None:
                return orig(self, gather_dim, group, tag)
            return _gloo_all_gather(self, gather_dim, pg)
        return f

    def reduce_scatter(orig):
        def f(self, reduceOp, scatter_dim, group, tag=""):
            pg = _gloo_card_group(self, group)
            if pg is None:
                return orig(self, reduceOp, scatter_dim, group, tag)
            return _gloo_reduce_scatter(self, reduceOp, scatter_dim, pg)
        return f

    def all_reduce(orig):
        def f(self, reduceOp, group, tag=""):
            pg = _gloo_card_group(self, group)
            if pg is None:
                return orig(self, reduceOp, group, tag)
            return _gloo_all_reduce(self, reduceOp, pg)
        return f

    def all_to_all(orig):
        def f(self, output_split_sizes, input_split_sizes, group, tag=""):
            pg = _gloo_card_group(self, group)
            if pg is None:
                return orig(self, output_split_sizes, input_split_sizes,
                            group, tag)
            return _gloo_all_to_all(self, output_split_sizes,
                                    input_split_sizes, pg)
        return f

    for names, wrap in ((("all_gather_tensor", "all_gather_single"), gather),
                        (("reduce_scatter_tensor", "reduce_scatter_single"),
                         reduce_scatter),
                        (("all_reduce",), all_reduce),
                        (("all_to_all_single",), all_to_all)):
        for name in names:
            if hasattr(funcol, name):
                setattr(funcol, name, wrap(getattr(funcol, name)))

    original = cu.shard_dim_alltoall

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        pg = _gloo_card_group(input, (mesh, mesh_dim))
        if pg is None:
            return original(input, gather_dim, shard_dim, mesh, mesh_dim)
        return _gloo_shard_move(input, gather_dim, shard_dim, pg)

    cu.shard_dim_alltoall = shard_dim_alltoall
    if hasattr(pt, "shard_dim_alltoall"):
        pt.shard_dim_alltoall = shard_dim_alltoall
    funcol._gloo_card = True


def _gloo_card_group(x, group):
    """The gloo process group of a functional collective's ``group`` when
    ``x`` is on a card, else None."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        return None
    if isinstance(group, tuple) and len(group) == 2 and isinstance(
            group[0], DeviceMesh):
        pg = group[0].get_group(group[1])
    elif isinstance(group, DeviceMesh) and group.ndim == 1:
        pg = group.get_group()
    elif isinstance(group, dist.ProcessGroup):
        pg = group
    else:
        return None
    return pg if dist.get_backend(pg) == "gloo" else None


_REDUCE = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN",
           "product": "PRODUCT"}
#: op -> [calls, bytes this rank handed in] of the routed collectives
#: since the last ``gloo_card_traffic(reset=True)``
_TRAFFIC: dict = {}


def gloo_card_traffic(reset: bool = False) -> dict:
    """{op: (calls, input bytes)} of the collectives this process routed
    through ``gloo_card_collectives`` (a card's tensors over gloo)."""
    out = {k: tuple(v) for k, v in _TRAFFIC.items()}
    if reset:
        _TRAFFIC.clear()
    return out


def _count(op: str, x):
    entry = _TRAFFIC.setdefault(op, [0, 0])
    entry[0] += 1
    entry[1] += x.numel() * x.element_size()


def _gloo_all_reduce(x, op: str, pg):
    import torch.distributed as dist
    _count("all_reduce", x)
    y = x.contiguous().clone()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, _REDUCE[op.lower()]),
                    group=pg)
    if op.lower() == "avg":
        y.div_(dist.get_world_size(pg))
    return y


def _gloo_all_gather(x, dim: int, pg):
    import torch.distributed as dist
    _count("all_gather", x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(parts, x, group=pg)
    return torch.cat(parts, dim=dim)


def _gloo_reduce_scatter(x, op: str, dim: int, pg):
    import torch.distributed as dist
    _count("reduce_scatter", x)
    n = dist.get_world_size(pg)
    parts = [c.contiguous() for c in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[dist.get_rank(pg)])
    dist.reduce_scatter(out, parts, op=getattr(
        dist.ReduceOp, _REDUCE[op.lower()]), group=pg)
    if op.lower() == "avg":
        out.div_(n)
    return out


def _gloo_all_to_all(x, out_splits, in_splits, pg):
    import torch.distributed as dist
    _count("all_to_all", x)
    x = x.contiguous()
    shape = list(x.shape)
    if out_splits is not None:
        shape[0] = sum(out_splits)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x, out_splits, in_splits, group=pg)
    return out


def _gloo_shard_move(x, gather_dim: int, shard_dim: int, pg):
    import torch.distributed as dist
    full = _gloo_all_gather(x, gather_dim, pg)
    return full.chunk(dist.get_world_size(pg), dim=shard_dim)[
        dist.get_rank(pg)].contiguous()
