"""Checks that run inside the workers of a ``repro_torch.core.ranks``
``RankPool`` (``RankPool.run_on``), for ``tests/test_torch_spmd.py`` and
``tests/test_torch_partitioning.py``. Each function takes the worker
first. No JAX here: a worker imports only this module, torch and
``repro_torch``."""
import itertools

import torch

KINDS = {"batch": 2, "hidden": 3, "hidden_full": 3, "logits": (2, 3),
         "attn_q": 4, "attn_kv": 4, "kv_cache": 4, "state": (2, 4),
         "expert": 4, "moe_mask": 3, "moe_counts": 2, "moe_dispatch": 4,
         "no_such_kind": 2}
DIMS = (1, 4, 6)


def constrain_layouts(w, key, run, kinds=None):
    """For every kind and shape of the grid: ``constrain`` of a DTensor
    (from Replicate, and from a shard of its last dim where the model
    axis divides it) under the mesh's rules has the placements of
    ``rules.spec`` and the input's values; a plain tensor, an unknown
    kind and ``mesh=None`` rules give ``x`` itself. Returns the
    mismatches."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs.base import MeshConfig
    from repro_torch.runtime.partitioning import (ShardingRules, constrain,
                                                  placements, sharding_scope)
    mesh = w.mesh(key)
    shape, axes, _ = key
    rules = ShardingRules(MeshConfig(tuple(shape), tuple(axes)), run, mesh)
    meta = ShardingRules(MeshConfig(tuple(shape), tuple(axes)), run)
    bad = []
    for kind, ranks in (kinds or KINDS).items():
        for rank in (ranks if isinstance(ranks, tuple) else (ranks,)):
            for shp in itertools.product(DIMS, repeat=rank):
                full = torch.arange(float(torch.Size(shp).numel())).reshape(
                    shp)
                starts = [(Replicate(), Replicate())]
                if shp[-1] % mesh.size(1) == 0:
                    starts.append((Replicate(), Shard(len(shp) - 1)))
                for start in starts:
                    x = DTensor.from_local(
                        full.clone() if start[1] == Replicate() else
                        full.chunk(mesh.size(1), dim=-1)[
                            mesh.get_local_rank(1)].contiguous(),
                        mesh, start, run_check=False)
                    with sharding_scope(rules):
                        y = constrain(x, kind)
                        plain = constrain(full, kind)
                    with sharding_scope(meta):
                        same = constrain(x, kind)
                    try:
                        want = placements(rules.spec(kind, shp), axes)
                    except KeyError:
                        want = start
                        if y is not x:
                            bad.append((kind, shp, "KeyError kind moved"))
                    if tuple(y.placements) != tuple(want):
                        bad.append((kind, shp, str(y.placements), str(want)))
                    if not torch.equal(y.full_tensor(), full):
                        bad.append((kind, shp, "values"))
                    if plain is not full or same is not x:
                        bad.append((kind, shp, "not the identity"))
    return bad


def tenants_held(w):
    """The tenant ids whose tensors this worker holds."""
    return sorted(w.tenants)


def comm_counts(w, tid):
    """One train step of tenant ``tid`` under ``CommDebugMode``: the
    collective counts by name."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.pipeline import SyntheticSource
    wt = w.tenants[tid]
    train_step, _ = wt.fns()
    src = SyntheticSource(wt.run, batch_override=4, seq_override=16)
    batch = w._batch(wt, src.batch_at(0))
    mode = CommDebugMode()
    with mode:
        wt.state, _ = train_step(wt.state, batch)
    return {str(k): int(v) for k, v in mode.get_comm_counts().items()}


def foreign_modules(w):
    """The modules of JAX or of the JAX package this worker holds."""
    import sys
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def gloo_routes(w):
    """The synchronous routes ``gloo_card_collectives`` takes for a card's
    tensors, run here on CPU tensors over the world group, against the
    functional collectives: the max abs difference of each."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    from repro_torch.runtime import partitioning as pt
    pg = dist.group.WORLD
    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(n * 6 * 4, dtype=torch.float32).reshape(n * 6, 4) \
        * (r + 1)

    def err(a, b):
        a = a.wait() if hasattr(a, "wait") else a
        return float((a - b).abs().max())
    return {
        "all_gather": err(funcol.all_gather_tensor(x, 1, pg),
                          pt._gloo_all_gather(x, 1, pg)),
        "all_reduce": err(funcol.all_reduce(x, "sum", pg),
                          pt._gloo_all_reduce(x, "sum", pg)),
        "avg": err(funcol.all_reduce(x, "avg", pg),
                   pt._gloo_all_reduce(x, "avg", pg)),
        "reduce_scatter": err(funcol.reduce_scatter_tensor(x, "sum", 0, pg),
                              pt._gloo_reduce_scatter(x, "sum", 0, pg)),
        "all_to_all": err(funcol.all_to_all_single(x, None, None, pg),
                          pt._gloo_all_to_all(x, None, None, pg)),
        "shard_move": err(funcol.all_gather_tensor(x, 0, pg).chunk(
            n, dim=1)[r], pt._gloo_shard_move(x, 0, 1, pg)),
    }
