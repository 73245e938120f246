"""Serve-step builders (mirrors the serve half of ``repro.train.step``).

The train step (``init_train_state``, ``make_train_step``) comes with the
training slice (ROADMAP Queue 1 item 4). PyTorch runs eagerly, so the
returned functions are plain closures where the JAX package returns
functions to ``jit``.
"""
from __future__ import annotations

from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.model import build_model, ops_backend


def make_serve_steps(run: RunConfig):
    """Returns (prefill_fn, decode_fn): the model's prefill, and its
    decode over the dense cache with one position for the whole batch
    (``decode(params, cache, tokens, pos)``, pos an int or a 0-d
    tensor)."""
    model = build_model(run)
    return model.prefill, model.decode_step


def make_decode_step(run: RunConfig, *, paged: bool = False,
                     fused: bool = False):
    """Continuous-batching decode step with an active-slot mask over the
    paged-KV page pool (a block table rides along; see
    ``Model.decode_step``).

    With ``fused`` the step also takes per-slot sampling params
    (temp (B,) f32, top_k (B,) i32, keys (B,3) i32 = (seed, rid,
    token_counter)) and returns SAMPLED TOKEN IDS (B,) i32 instead of
    logits — temperature/top-k Gumbel sampling runs on the device
    (``kernels/ops.fused_sample``), bit-identical to
    ``ServeEngine._sample``, and the (B, V) logits never leave it."""
    if not paged:
        raise NotImplementedError(
            "dense (non-paged) decode layout is not ported yet "
            "(ROADMAP: deferred serve-engine parts)")
    model = build_model(run)
    backend = ops_backend(run)

    if fused:
        def decode(params, cache, tokens, pos, tables, active,
                   temp, topk, keys):
            logits, cache = model.decode_step(params, cache, tokens, pos,
                                              tables=tables, active=active)
            return kops.fused_sample(logits, temp, topk, keys,
                                     vocab_size=run.model.vocab_size,
                                     backend=backend), cache
    else:
        def decode(params, cache, tokens, pos, tables, active):
            return model.decode_step(params, cache, tokens, pos,
                                     tables=tables, active=active)
    return decode
