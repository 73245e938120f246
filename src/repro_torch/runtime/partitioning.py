"""Sharding rules as layout metadata (mirrors
``repro.runtime.partitioning``).

The JAX package resolves logical activation kinds ("hidden", "logits",
...) and parameter paths to ``PartitionSpec``s for its meshes, with
divisibility fallbacks so that the same model runs on the unit mesh, the
single-pod 16x16 mesh and the multi-pod 2x16x16 mesh. The port keeps the
same rules and gives the same answers: a spec is a ``P``, a tuple whose
entries are ``None``, a mesh-axis name or a tuple of names, so
``tuple(p) == tuple(jax_spec)`` compares the two directly.

One card holds every slot of the port's pool, so no path of the port runs
a model over a device mesh. The specs describe the layout (a pause
snapshot's ``sharding_desc``, a VF's config space), and ``named`` /
``placements`` map them to DTensor placements for a
``torch.distributed.device_mesh.DeviceMesh``. ``constrain`` is the
identity on a one-device mesh, as in JAX, and raises on a larger one.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Optional

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
    """Apply a logical sharding constraint if a scope is active: the
    identity on a one-device mesh (and with no scope), as in JAX. A larger
    mesh raises: no path of the port runs a model over a device mesh."""
    rules = current_rules()
    if rules is None or rules.mesh_cfg.num_devices <= 1:
        return x
    raise NotImplementedError(
        f"constrain({kind!r}) on a {rules.mesh_cfg.num_devices}-device mesh: "
        "the port runs every model on one card")
