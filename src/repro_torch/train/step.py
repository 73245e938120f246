"""Train-, eval- and serve-step builders (mirrors ``repro.train.step``).

PyTorch runs eagerly, so each builder returns a plain closure where the
JAX package returns a function to ``jit``:

  make_train_step   (state, batch) -> (state, metrics): loss and
                    gradients (autograd over the plain attention and SSM
                    scan, as JAX's reference backend), optional microbatch
                    accumulation, global-norm clipping, the scheduled
                    learning rate and the optimizer update. The update
                    writes the params and moments in place: the returned
                    state holds the same tensors as the one passed in.
  make_eval_step    (params, batch) -> metrics under ``torch.no_grad()``,
                    where the forward launches the CUDA kernels on a card
  make_serve_steps  the model's prefill and uniform-position decode
  make_prefill_chunk  one chunk of a chunked prefill (all-attention
                    stacks)

A train state is ``{"params", "opt", "step"}``, ``step`` a 0-d int32
tensor. ``train_state_specs`` and ``batch_specs`` give its layout and a
batch's under ``runtime.partitioning.ShardingRules``, equal to the JAX
package's specs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.model import build_model, ops_backend
from repro_torch.runtime.partitioning import (P, ShardingRules, is_dtensor,
                                              local_shard, place_tree,
                                              placements, spmd_scope,
                                              zeros_tree)
from repro_torch.train.optim import (build_optimizer, clip_by_global_norm,
                                     lr_schedule)
from repro_torch.tree import flatten, tree_map, unflatten


def init_train_state(run: RunConfig, seed: int = 0, device="cuda",
                     rules: Optional[ShardingRules] = None) -> dict:
    """Params from ``Model.init(seed)`` on ``device``, zeroed optimizer
    state and step 0. With ``rules`` holding a ``DeviceMesh`` every member
    rank draws the same full params and keeps its block of each, as
    ``train_state_specs`` lays them out: the values are the one-device
    init's, bit for bit."""
    dev = resolve_device(device)
    params = build_model(run).init(seed=seed, device=dev)
    opt = build_optimizer(run.optimizer)
    if rules is None or rules.mesh is None:
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}
    places = rules.named(train_state_specs(run, rules))
    shapes = train_state_shapes(run)
    return {"params": place_tree(params, rules.mesh, places["params"]),
            "opt": zeros_tree(shapes["opt"], rules.mesh, places["opt"], dev),
            "step": zeros_tree(shapes["step"], rules.mesh, places["step"],
                               dev)}


def train_state_shapes(run: RunConfig) -> dict:
    """The train state's tree as tensors on the ``meta`` device: shapes
    and dtypes, no bytes (the restore template of ``CheckpointStore`` and
    ``Tenant.state_template``)."""
    pshapes = build_model(run).param_shapes()
    params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                            device="meta"), pshapes)
    return {"params": params,
            "opt": build_optimizer(run.optimizer).init(params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def train_state_specs(run: RunConfig, rules: ShardingRules) -> dict:
    """Spec tree matching ``train_state_shapes``."""
    pshapes = build_model(run).param_shapes()
    pspecs = rules.param_specs(pshapes)
    opt = build_optimizer(run.optimizer)
    return {"params": pspecs,
            "opt": opt.state_specs(rules, pspecs, pshapes), "step": P()}


def batch_specs(run: RunConfig, rules: ShardingRules) -> dict:
    """A step's inputs: the batch dim over the data axes where it divides
    them, every other dim replicated."""
    out = {}
    for k, v in build_model(run).input_specs().items():
        if v.shape == ():
            out[k] = P()
        else:
            out[k] = P(rules._fit(v.shape[0], rules.dp_axes),
                       *([None] * (len(v.shape) - 1)))
    return out


def place_batch(batch: dict, rules: ShardingRules, device) -> dict:
    """A global batch (numpy arrays or tensors, the same on every rank) as
    DTensors on ``rules.mesh``, laid out by its ACTUAL shapes as the JAX
    tenant places it: the batch dim over the data axes where it divides
    them, else replicated; each rank keeps its block."""
    from torch.distributed.tensor import DTensor
    mesh = rules.mesh
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v).to(device)
        spec = P(rules._fit(t.shape[0], rules.dp_axes),
                 *([None] * (t.dim() - 1)))
        pl = placements(spec, mesh.mesh_dim_names)
        out[k] = DTensor.from_local(local_shard(t, mesh, pl), mesh, pl,
                                    run_check=False)
    return out


def _like(g, p):
    """A gradient laid out as its param: a DTensor's pending sums reduced
    once here (a reduce-scatter or an all-reduce), as JAX's gradients
    take the params' shardings, rather than again at each later use (the
    norm, each moment)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _mean(ms: list) -> dict:
    """Metrics of the microbatches averaged key by key (an integer count
    averages to fp32, as ``jnp.mean`` gives)."""
    return {k: torch.stack([m[k] for m in ms]).to(torch.float32).mean(0)
            for k in ms[0]}


def make_train_step(run: RunConfig, rules: Optional[ShardingRules] = None,
                    total_steps: int = 10000):
    """With ``rules`` holding a ``DeviceMesh`` the step runs SPMD on the
    state's DTensors under ``spmd_scope(rules)``: the model's constraints
    lay the activations out, the optimizer updates each rank's blocks in
    place."""
    model = build_model(run)
    opt = build_optimizer(run.optimizer)
    sched = lr_schedule(run.optimizer, total_steps)

    def grads_of(params, batch):
        """(gradient tree, metrics) of the loss at ``params``. The grads
        flow to detached aliases of the param leaves, so the params
        themselves never carry ``requires_grad`` or ``.grad``."""
        flat, treedef = flatten(params)
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        with torch.enable_grad():
            loss, metrics = model.loss(unflatten(treedef, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _like(g, p)
                 for p, g in zip(leaves, grads)]
        return (unflatten(treedef, grads),
                {k: v.detach() for k, v in metrics.items()})

    def train_step(state, batch):
        with spmd_scope(rules):
            return _train_step(state, batch)

    def _train_step(state, batch):
        params = state["params"]
        if run.microbatch > 1:
            mb = run.microbatch
            grads, ms = None, []
            for i in range(mb):
                part = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                        for k, v in batch.items()}
                g, m = grads_of(params, part)
                g = tree_map(lambda x: x.to(torch.float32), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                ms.append(m)
            grads = tree_map(lambda g: g / mb, grads)
            metrics = _mean(ms)
        else:
            grads, metrics = grads_of(params, batch)

        grads, gnorm = clip_by_global_norm(grads, run.optimizer.grad_clip)
        lr = sched(state["step"])
        new_params, new_opt = opt.update(grads, state["opt"], params, lr)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return new_state, metrics

    return train_step


def make_eval_step(run: RunConfig, rules: Optional[ShardingRules] = None):
    """The loss's metrics with no gradient: on a card the forward launches
    ``flash_attention`` (and ``ssm_scan``), as JAX's eval step reaches the
    Pallas kernels under ``kernel_backend="pallas"``; on DTensors each
    rank launches it on its local heads (``models.attention``)."""
    model = build_model(run)

    @torch.no_grad()
    def eval_step(params, batch):
        with spmd_scope(rules):
            _, metrics = model.loss(params, batch)
        return metrics

    return eval_step


def make_serve_steps(run: RunConfig):
    """Returns (prefill_fn, decode_fn): the model's prefill, and its
    decode over the dense cache with one position for the whole batch
    (``decode(params, cache, tokens, pos)``, pos an int or a 0-d
    tensor)."""
    model = build_model(run)
    return model.prefill, model.decode_step


def make_prefill_chunk(run: RunConfig):
    """Chunked-prefill step (all-attention stacks only):
    ``chunk(params, cache, tokens, offset)`` -> (cache, logits (B,C,V)),
    the dense staging cache updated in place."""
    return build_model(run).prefill_chunk


def make_decode_step(run: RunConfig, *, paged: bool = False,
                     fused: bool = False):
    """Continuous-batching decode step with an active-slot mask: over the
    paged-KV page pool (``paged``, a block table rides along) or over the
    dense per-slot ring (per-slot positions into ``init_cache``'s cache);
    see ``Model.decode_step``.

    With ``fused`` the step also takes per-slot sampling params
    (temp (B,) f32, top_k (B,) i32, keys (B,3) i32 = (seed, rid,
    token_counter)) and returns SAMPLED TOKEN IDS (B,) i32 instead of
    logits — temperature/top-k Gumbel sampling runs on the device
    (``kernels/ops.fused_sample``), bit-identical to
    ``ServeEngine._sample``, and the (B, V) logits never leave it."""
    model = build_model(run)
    backend = ops_backend(run)

    def sample(logits, temp, topk, keys):
        return kops.fused_sample(logits, temp, topk, keys,
                                 vocab_size=run.model.vocab_size,
                                 backend=backend)

    if paged and fused:
        def decode(params, cache, tokens, pos, tables, active,
                   temp, topk, keys):
            logits, cache = model.decode_step(params, cache, tokens, pos,
                                              tables=tables, active=active)
            return sample(logits, temp, topk, keys), cache
    elif paged:
        def decode(params, cache, tokens, pos, tables, active):
            return model.decode_step(params, cache, tokens, pos,
                                     tables=tables, active=active)
    elif fused:
        def decode(params, cache, tokens, pos, active, temp, topk, keys):
            logits, cache = model.decode_step(params, cache, tokens, pos,
                                              active=active)
            return sample(logits, temp, topk, keys), cache
    else:
        def decode(params, cache, tokens, pos, active):
            return model.decode_step(params, cache, tokens, pos,
                                     active=active)
    return decode
