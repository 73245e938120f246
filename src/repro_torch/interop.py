"""Carry weights and staged snapshots between the JAX package and the
port.

The JAX package and the port name their parameter leaves alike and both
stack each block's leaves over a leading ``nper`` (period) axis, so a
tree converts leaf for leaf and both packages compute the same thing
from the same weights. The tests build params with the JAX init, pass
them here as numpy (``jax.tree.map(np.asarray, params)``), and feed both
packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.staging import QuantizedLeaf, _Opaque
from repro_torch.device import resolve_device
from repro_torch.tree import flatten, tree_map, unflatten


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes.bfloat16: same bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_jax(tree, device="cuda") -> dict:
    """Nested dict of numpy arrays (the JAX param tree) -> the same tree of
    torch tensors on ``device``, bit for bit."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_torch(a, dev), tree)


def params_to_jax(tree) -> dict:
    """Inverse of ``params_from_jax``: torch tensors -> numpy arrays (which
    ``jnp.asarray`` takes as they are)."""
    return tree_map(_to_numpy, tree)


#: a train state converts leaf for leaf like params: every leaf bit for
#: bit, 0-d ``count`` and ``step`` as 0-d int32 tensors / arrays
train_state_from_jax = params_from_jax
train_state_to_jax = params_to_jax


def staged_from_jax(payload):
    """A JAX ``StagingEngine.save`` payload -> the port's: every numpy
    leaf becomes a CPU tensor of the same bytes (the JAX payload does not
    tell device leaves from host ones, so all come over as tensors), and
    each packed leaf a port ``QuantizedLeaf`` of CPU tensors."""
    flat, treedef = flatten(payload, is_leaf=lambda x: hasattr(x, "leaf"))
    out = []
    for _, x in flat:
        if hasattr(x, "leaf"):                       # the JAX _Opaque
            ql = x.leaf
            x = _Opaque(QuantizedLeaf(
                q=_to_torch(ql.q, "cpu"), scale=_to_torch(ql.scale, "cpu"),
                dtype=str(ql.dtype), block=int(ql.block)))
        else:
            x = _to_torch(x, "cpu")
        out.append(x)
    return unflatten(treedef, out)


def staged_to_jax(payload, opaque_cls, quantized_cls):
    """The port's payload -> a JAX one, for ``repro.core.staging``'s
    ``_Opaque`` and ``QuantizedLeaf`` (passed in: the port does not
    import the JAX package). Tensors become numpy arrays of the same
    bytes (bfloat16 through ``ml_dtypes``); numpy leaves stay."""
    flat, treedef = flatten(payload, is_leaf=lambda x: isinstance(
        x, _Opaque))
    out = []
    for _, x in flat:
        if isinstance(x, _Opaque):
            ql = x.leaf
            x = opaque_cls(quantized_cls(
                q=_to_numpy(ql.q), scale=_to_numpy(ql.scale),
                dtype=ql.dtype, block=ql.block))
        elif isinstance(x, torch.Tensor):
            x = _to_numpy(x)
        out.append(x)
    return unflatten(treedef, out)
