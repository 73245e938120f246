"""Distributed-optimization collectives: the int8-compressed gradient
all-reduce (mirrors ``repro.runtime.collectives``).

The JAX package re-expresses a quantized ring all-reduce as a
reduce-scatter in full precision followed by an int8 all-gather: each
rank owns the exact fp32 mean of one row of the flattened gradient,
packs it once with the ``qdma_pack`` blockwise quantizer, and the packed
rows are gathered and unpacked with ``qdma_unpack``. Only the gather is
lossy, one quantization per value, so the error does not grow with the
number of ranks. Here the ranks are those of a ``torch.distributed``
process group: each passes its own replica's tensor (the JAX version's
stacked leading replica dim is the rank), and every rank gets the same
replica mean back, bit for bit.

Transport. The group's backend decides it, and the collectives take
the tensors where they lie: ``nccl`` with one card a rank, ``gloo`` for
the CPU tests and for several ranks sharing one card (NCCL refuses two
ranks on one device). Gloo takes the card's tensors for ``all_reduce``,
``reduce_scatter`` and ``all_gather`` and copies them through host
memory itself (``tools/gloo_cuda_probe.py``: torch 2.11 on an H100);
packing and unpacking stay on the card either way. ``WireStats`` counts
what a rank sends under the ring model beside what a plain fp32 ring
all-reduce of the same leaves would send: the compressed leaves cost
about (1 + 1/4) / 2 of it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops
from repro_torch.tree import flatten, unflatten

F32 = torch.float32


@dataclasses.dataclass
class WireStats:
    """Bytes one rank sends under the ring model: a reduce-scatter sends
    (n-1)/n of its input, an all-gather (n-1) times its own part, an
    all-reduce 2(n-1)/n of its input."""
    wire_bytes: float = 0.0
    plain_fp32_bytes: float = 0.0       # a plain fp32 all-reduce's
    compressed_leaves: int = 0
    exact_leaves: int = 0


def _world(group) -> int:
    if not dist.is_initialized():
        raise RuntimeError("the compressed all-reduce needs an initialised "
                           "torch.distributed process group")
    return dist.get_world_size(group)


# torch 2.13 deprecates the *_tensor spellings for the *_single ones
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def compressed_psum_mean(x: torch.Tensor, group=None, *, block: int = 256,
                         stats: Optional[WireStats] = None,
                         backend: str = "auto") -> torch.Tensor:
    """Mean over the group's ranks of each rank's ``x`` with an
    int8-compressed gather phase. ``x`` (any shape) is flattened to
    (n, per) fp32 rows, ``per`` a multiple of ``block``, zero-padded.
    ``backend`` goes to ``qdma_pack`` / ``qdma_unpack`` ("ref": their
    plain versions on any device)."""
    n = _world(group)
    numel = x.numel()
    flat = x.to(F32).reshape(-1)
    per = -(-numel // n)                        # ceil
    per = -(-per // block) * block              # block multiple
    rows = torch.zeros(n * per, dtype=F32, device=x.device)
    rows[:numel] = flat
    # exact reduce-scatter: each rank ends with the true mean of its row
    mine = torch.empty(per, dtype=F32, device=x.device)
    _reduce_scatter(mine, rows, group=group)
    mine = mine / n
    # lossy gather: quantize my exact row once, gather the packed rows
    q, s = kops.qdma_pack(mine.reshape(1, per), block=block, backend=backend)
    qg = torch.empty(n * per, dtype=torch.int8, device=x.device)
    sg = torch.empty(n * (per // block), dtype=F32, device=x.device)
    _all_gather(qg, q.reshape(-1), group=group)
    _all_gather(sg, s.reshape(-1), group=group)
    out = kops.qdma_unpack(qg.reshape(n, per), sg.reshape(n, per // block),
                           dtype=F32, backend=backend)
    if stats is not None:
        f = (n - 1) / n
        stats.wire_bytes += (f * n * per * 4
                             + (n - 1) * (per + (per // block) * 4))
        stats.plain_fp32_bytes += 2 * f * numel * 4
        stats.compressed_leaves += 1
    return out.reshape(-1)[:numel].reshape(x.shape).to(x.dtype)


def exact_mean(x: torch.Tensor, group=None, *,
               stats: Optional[WireStats] = None) -> torch.Tensor:
    """The JAX ``pmean``: an all-reduce sum in ``x``'s dtype, then / n."""
    n = _world(group)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    if stats is not None:
        f = (n - 1) / n
        stats.wire_bytes += 2 * f * x.numel() * x.element_size()
        stats.plain_fp32_bytes += 2 * f * x.numel() * 4
        stats.exact_leaves += 1
    return out / n


def compressed_grad_allreduce(grads, group=None, block: int = 256, *,
                              stats: Optional[WireStats] = None,
                              backend: str = "auto"):
    """Tree-wise replica mean of each rank's gradient tree (the same
    structure on every rank), the same on every rank. Leaves of fewer than
    ``4 * block`` values take the exact mean: compression does not pay
    there. The leaves go in sorted-key order, the same on every rank."""
    _world(group)
    flat, treedef = flatten(grads)
    out = [exact_mean(g, group, stats=stats) if g.numel() < 4 * block else
           compressed_psum_mean(g, group, block=block, stats=stats,
                                backend=backend)
           for _, g in flat]
    return unflatten(treedef, out)
