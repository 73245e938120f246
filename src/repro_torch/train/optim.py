"""Optimizers (mirrors ``repro.train.optim``): AdamW, Adafactor and SGD.

Each exposes
  init(params)                      -> opt_state (a tree of tensors)
  update(grads, state, params, lr)  -> (params, opt_state)
  state_specs(rules, param_specs, param_shapes) -> spec tree (the
    optimizer state lays out like the params it mirrors; Adafactor's
    factored moments drop the corresponding spec dims)

with the JAX package's arithmetic, in fp32. JAX returns new trees; here
``update`` writes the params and the moments in place (under
``torch.no_grad()``), so a step holds one copy of the state on the card,
and returns the same param tensors in a new tree beside the new state
(whose ``count`` is a new 0-d tensor). Scalars (``lr``, ``count`` and the bias corrections) stay 0-d
tensors on the params' device, so a step never waits on the host.

Adafactor (factored second moments, no first moment) is the default of
the 400B-class architectures (jamba) in both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.runtime.partitioning import P
from repro_torch.tree import flatten, tree_map

F32 = torch.float32


def lr_schedule(cfg: OptimizerConfig, total_steps: int = 10000):
    """Linear warmup over ``cfg.warmup`` steps, then a cosine from 1 to
    0.1 over the rest. ``lr(step)`` takes an int or a 0-d tensor and
    returns a 0-d fp32 tensor (on the step's device)."""
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = torch.clamp((step + 1) / max(cfg.warmup, 1), max=1.0)
        t = torch.clamp((step - cfg.warmup)
                        / max(total_steps - cfg.warmup, 1), 0.0, 1.0)
        cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * t))
        return cfg.lr * warm * cos
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the JAX package's sorted-key order)
    of each leaf's sum of squares, in fp32."""
    sq = [x.to(F32).square().sum() for _, x in flatten(tree)[0]]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), the norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gn


@dataclass
class Optimizer:
    cfg: OptimizerConfig
    init: Callable
    update: Callable                 # (grads, state, params, lr) -> (p, s)
    state_specs: Callable            # (rules, param_specs, shapes) -> specs


def _leaves(tree) -> list:
    return [x for _, x in flatten(tree)[0]]


def _count(params):
    dev = _leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _apply(p, step, lr, wd):
    """p <- p - lr * (step + wd * p) (decoupled weight decay on matrices),
    computed in fp32 and stored in p's dtype."""
    p32 = p.to(F32)
    if p.dim() >= 2:
        step = step + wd * p32
    p.copy_((p32 - lr * step).to(p.dtype))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def make_adamw(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state["count"] + 1
        b1, b2 = cfg.beta1, cfg.beta2
        bc1 = 1 - b1 ** c.to(F32)
        bc2 = 1 - b2 ** c.to(F32)

        def upd(g, m, v, p):
            g32 = g.to(F32)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32.square())
            step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            _apply(p, step, lr, cfg.weight_decay)

        tree_map(upd, grads, state["m"], state["v"], params)
        return params, {"m": state["m"], "v": state["v"], "count": c}

    def state_specs(rules, param_specs, shapes):
        return {"m": param_specs, "v": param_specs, "count": P()}

    return Optimizer(cfg, init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored v for ndim>=2 over the last two dims)
# ---------------------------------------------------------------------------
def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def make_adafactor(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        def one(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=F32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
        return {"f": tree_map(one, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state["count"] + 1
        beta2 = 1.0 - c.to(F32) ** -0.8
        eps = 1e-30

        def upd(g, p, s):
            g32 = g.to(F32)
            g2 = g32.square() + eps
            if _factored(p):
                s["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
                s["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
                vr, vc = s["vr"], s["vc"]
                rfac = torch.rsqrt(vr / vr.mean(dim=-1, keepdim=True) + eps)
                cfac = torch.rsqrt(vc + eps)
                step = g32 * rfac[..., None] * cfac[..., None, :]
            else:
                s["v"].mul_(beta2).add_((1 - beta2) * g2)
                step = g32 * torch.rsqrt(s["v"] + eps)
            # update clipping (RMS <= 1) — adafactor's stability trick
            rms = torch.sqrt(step.square().mean() + eps)
            step = step / torch.clamp(rms, min=1.0)
            _apply(p, step, lr, cfg.weight_decay)

        # params lead the walk: each param leaf meets its {"vr", "vc"} or
        # {"v"} node of the factored state
        tree_map(lambda p, g, s: upd(g, p, s), params, grads, state["f"])
        return params, {"f": state["f"], "count": c}

    def state_specs(rules, param_specs, shapes):
        def one(spec, shape):
            dims = tuple(shape.shape)
            sp = tuple(spec) + (None,) * (len(dims) - len(spec))
            if len(dims) >= 2 and dims[-1] > 1 and dims[-2] > 1:
                return {"vr": P(*sp[:-1]), "vc": P(*(sp[:-2] + sp[-1:]))}
            return {"v": P(*sp)}
        return {"f": tree_map(one, param_specs, shapes), "count": P()}

    return Optimizer(cfg, init, update, state_specs)


def make_sgd(cfg: OptimizerConfig) -> Optimizer:
    def init(params):
        return {"count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        tree_map(lambda g, p: p.copy_((p.to(F32) - lr * g.to(F32))
                                      .to(p.dtype)), grads, params)
        return params, {"count": state["count"] + 1}

    def state_specs(rules, param_specs, shapes):
        return {"count": P()}

    return Optimizer(cfg, init, update, state_specs)


def build_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return {"adamw": make_adamw, "adafactor": make_adafactor,
            "sgd": make_sgd}[cfg.name](cfg)
