"""Mixture-of-Experts FFN — GShard-style top-k routing with capacity
(mirrors ``repro.models.moe``).

Tokens are cut into fixed-size groups (``GROUP_SIZE``, or the whole
sequence when shorter) and each group routes on its own: top-k experts
per token from an fp32 softmax over the router logits, a per-group
capacity per expert, and tokens past an expert's capacity dropped (their
combine weight is zero). The dispatch and combine tensors are one-hots
over (group, token, expert, capacity slot) in the compute dtype, and the
experts run as dense ``torch.einsum`` products over every expert, as the
JAX package computes them outside any Pallas kernel: a decode step reads
every expert's weights.

The port never pads a sequence into whole groups: ``moe_ffn`` raises
``ValueError`` when ``B * S`` is not a multiple of the group size (the
JAX package asserts it), and the serve engine rejects such a prompt at
admission (``check_moe_groups``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

GROUP_SIZE = 512  # tokens per routing group (capacity is per-group)


def check_moe_groups(B: int, S: int) -> int:
    """The group size sg = min(GROUP_SIZE, S); routing needs (B*S) % sg
    == 0. Padding the tokens instead would route the pad tokens and take
    capacity from the real ones."""
    sg = min(GROUP_SIZE, S)
    if sg < 1 or (B * S) % sg:
        raise ValueError(
            f"moe_ffn: {B} x {S} tokens break the group rule "
            f"(B*S) % min({GROUP_SIZE}, S) == 0: a prompt must be at most "
            f"{GROUP_SIZE} tokens or a multiple of {GROUP_SIZE}")
    return sg


def capacity(sg: int, moe: MoEConfig) -> int:
    """Slots per expert in a group of ``sg`` tokens: Python's ``round``
    (half to even) of sg*k/E*capacity_factor, at least 1 — the JAX
    package's rule, so 2.5 rounds to 2 and a decode step's group of one
    token gets one slot."""
    K, E = moe.num_experts_per_token, moe.num_experts
    return int(max(1, round(sg * K / E * moe.capacity_factor)))


def route(logits: torch.Tensor, moe: MoEConfig, cdt):
    """Routing of (G, sg, E) fp32 router logits: returns (probs, idx
    (G,sg,K), dispatch, combine (G,sg,E,C) in ``cdt``).

    top-k is a stable descending sort, so equal probabilities pick the
    lower expert first, as ``jax.lax.top_k`` does. Slots are assigned
    choice by choice (all tokens' first choices, then their second, ...)
    with a running count per expert, each choice's position a cumsum
    over the group's tokens; a token whose position reaches the capacity
    is dropped from that expert."""
    G, sg, E = logits.shape
    K = moe.num_experts_per_token
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[..., :K], idx[..., :K]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    cap = capacity(sg, moe)
    slots = torch.arange(cap, device=logits.device)
    counts = torch.zeros((G, E), dtype=torch.float32, device=logits.device)
    dispatch = torch.zeros((G, sg, E, cap), dtype=cdt, device=logits.device)
    combine = torch.zeros_like(dispatch)
    for i in range(K):
        m = F.one_hot(idx[:, :, i], E).to(torch.float32)        # (G,sg,E)
        pos = counts[:, None, :] + torch.cumsum(m, dim=1) - m    # slot index
        keep = (pos < cap).to(torch.float32) * m
        counts = counts + keep.sum(1)
        # a position at or past the capacity is an all-zero row, as
        # jax.nn.one_hot gives for an index out of range
        slot = (pos.to(torch.int64)[..., None] == slots).to(torch.float32)
        d_i = keep[..., None] * slot                             # (G,sg,E,C)
        dispatch = dispatch + d_i.to(cdt)
        combine = combine + (gate_vals[:, :, i][..., None, None]
                             * d_i).to(cdt)
    return probs, idx, dispatch, combine


def moe_ffn(x: torch.Tensor, p: dict, moe: MoEConfig, cdt):
    """x: (B, S, D) -> (y, aux) where aux = {load_balance, router_z}
    losses (0-d fp32 tensors)."""
    B, S, D = x.shape
    E, K = moe.num_experts, moe.num_experts_per_token
    sg = check_moe_groups(B, S)
    G = (B * S) // sg
    xg = x.reshape(G, sg, D).to(cdt)

    # router: a matmul in the compute dtype, the softmax in fp32
    logits = (xg @ p["router"].to(cdt)).to(torch.float32)      # (G, sg, E)
    probs, _, dispatch, combine = route(logits, moe, cdt)

    # expert computation over every expert
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)   # (E,G,C,D)
    h = F.silu(torch.einsum("egcd,edf->egcf", expert_in, p["wg"].to(cdt)))
    h = h * torch.einsum("egcd,edf->egcf", expert_in, p["wi"].to(cdt))
    out = torch.einsum("egcf,efd->egcd", h, p["wo"].to(cdt))
    y = torch.einsum("gsec,egcd->gsd", combine, out)

    # aux losses: load balance E * sum_e mean_prob_e * mean_dispatch_frac_e
    # (over k), and the router z-loss
    frac = dispatch.to(torch.float32).sum(-1).mean(dim=(0, 1))   # (E,)
    mean_p = probs.mean(dim=(0, 1))
    lb = E * (frac * mean_p).sum() / K
    z = torch.logsumexp(logits, dim=-1).square().mean()
    aux = {"load_balance": moe.load_balance_loss * lb,
           "router_z": moe.router_z_loss * z}
    return y.reshape(B, S, D), aux
