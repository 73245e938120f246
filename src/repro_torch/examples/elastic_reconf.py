"""Elastic reconfiguration — the paper's headline scenario, plus the
elasticity it enables (mirrors ``examples/elastic_reconf.py``):

 1. one tenant trains on a 2-device VF;
 2. demand arrives: the pool is reconfigured to add a second tenant —
    the first tenant is PAUSED (not detached: its guest keeps the device)
    and unpaused on the new layout, continuing bit-identically;
 3. the second tenant leaves; the first is elastically scaled UP to all 8
    devices via pause -> repartition -> unpause, its train state laid out
    for the larger mesh on unpause;
 4. a straggler/failure is injected and the Supervisor migrates the tenant
    using the same pause machinery (fault tolerance = reconfiguration).

The JAX example forces eight host devices; here the pool's eight
devices are the ranks of a ``RankPool`` (eight worker processes, one
gloo world, all on the card or all on the CPU). The tenant's train state
lives on its VF's ranks as DTensors, each rank holding its blocks, and
is really resharded on each unpause: (2, 1) before the rescale, (4, 2)
on all eight ranks, (2, 2) on four. Each step checks what it claims:
the state after an unpause equals the paused one bit for bit, every
rank holds the bytes the specs give it, and the layout a paused
tenant's snapshot carries (``sharding_desc``) is the train state's specs
for that VF's mesh.

Run:  PYTHONPATH=src python -m repro_torch.examples.elastic_reconf [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import MeshConfig, make_run_config
from repro_torch.core import DevicePool, SVFFManager, Supervisor, Tenant
from repro_torch.core.ranks import RankPool
from repro_torch.core.snapshot import serialize_specs
from repro_torch.runtime.partitioning import ShardingRules
from repro_torch.train.step import train_state_specs

RANKS = 8


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    return ap


def gathered(tn) -> dict:
    """The tenant's full state, gathered from its ranks."""
    return tn.export_state().gather()


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def checked_blocks(tn) -> dict:
    """rank -> bytes it holds of the tenant's state, checked against the
    specs of the VF's mesh."""
    st = tn.export_state()
    held = {r: m[0] for r, m in st.memory().items()}
    if held != st.shardings.local_bytes():
        raise RuntimeError(f"{tn.tid}: the ranks hold {held}, the specs "
                           f"give {st.shardings.local_bytes()}")
    return held


def checked_desc(run, desc, mesh_shape, mesh_axes) -> list:
    """``desc`` if it is the train state's layout on this mesh, else an
    error."""
    want = serialize_specs(train_state_specs(run, ShardingRules(
        MeshConfig(tuple(mesh_shape), tuple(mesh_axes)), run)))
    if desc != want:
        raise RuntimeError(f"the snapshot's layout on {tuple(mesh_shape)} "
                           "is not the train state's specs for that mesh")
    return desc


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    run = make_run_config("qwen3-0.6b", "train_4k", smoke=True)
    descs, resharded = {}, []
    with RankPool(RANKS, device=args.device) as ranks, \
            tempfile.TemporaryDirectory(prefix="svff_el_") as workdir:
        pool = DevicePool(ranks.ranks)
        mgr = SVFFManager(pool, workdir=workdir)

        def pause_and_check(tn):
            before = gathered(tn)
            mgr.pause(tn)
            snap = mgr.snapshots[tn.tid]
            shape = tuple(snap.mesh_shape)
            descs[shape] = checked_desc(run, snap.sharding_desc, shape,
                                        snap.mesh_axes)
            return before

        def unpause_and_check(tn, before, n):
            mgr.unpause(tn, num_devices=n)
            if not same(gathered(tn), before):
                raise RuntimeError(f"{tn.tid}'s state changed on the "
                                   "unpause")
            checked_blocks(tn)
            resharded.append(tuple(pool.find(tn.vf_id).mesh_shape))

        # 1. single tenant on 2 devices
        a = Tenant("vmA", run, local_batch=2, seq_len=32, seed=0,
                   device=args.device)
        mgr.init(num_vfs=4, tenants=[a], devices_per_vf=2)
        a.run_steps(3)
        checked_blocks(a)
        print(f"[1] vmA on {pool.find(a.vf_id).mesh_shape} "
              f"steps={a.steps_done}")

        # 2. add a second tenant without disturbing vmA's guest
        before = gathered(a)
        b = Tenant("vmB", run, local_batch=2, seq_len=32, seed=1,
                   device=args.device)
        mgr.tenants["vmB"] = b
        t = mgr.reconf(num_vfs=4, new_tenants=[b], devices_per_vf=2)
        if not same(gathered(a), before):
            raise RuntimeError("the reconfiguration changed vmA's state")
        a.run_steps(1)
        b.run_steps(1)
        print(f"[2] reconf added vmB in {t['total']*1000:.0f}ms; "
              f"vmA state preserved, both running")

        # 3. vmB leaves; scale vmA up to all 8 devices
        mgr.detach(b)
        before = pause_and_check(a)
        pool.set_num_vfs(1, devices_per_vf=8)
        unpause_and_check(a, before, 8)
        a.run_steps(2)
        print(f"[3] vmA elastically rescaled to "
              f"{pool.find(a.vf_id).mesh_shape} (8 ranks), "
              f"steps={a.steps_done} — its state resharded on unpause")

        # 4. failure -> supervisor migrates via pause machinery.
        #    Scale vmA back to 4 devices so 4 stay free as spares.
        before = pause_and_check(a)
        pool.set_num_vfs(2, devices_per_vf=4)
        unpause_and_check(a, before, 4)
        vf = pool.find(a.vf_id)
        descs[tuple(vf.mesh_shape)] = checked_desc(
            run, serialize_specs(a.export_specs()), vf.mesh_shape,
            vf.mesh_axes)
        sup = Supervisor(mgr)
        a.inject_failure()
        sup.run_round(1)
        kinds = [e["kind"] for e in sup.events]
        print(f"[4] injected failure -> events: {kinds}; vmA back at "
              f"steps={a.steps_done} on {pool.find(a.vf_id).mesh_shape}")
        print(f"    layouts checked on meshes {sorted(descs)}; state "
              f"resharded bit-equal onto {resharded}")
        blocks = checked_blocks(a)
        mgr.staging.close()
    return {"sharding_desc": descs, "events": kinds,
            "steps_done": a.steps_done, "resharded": resharded,
            "rank_bytes": blocks}


if __name__ == "__main__":
    main()
