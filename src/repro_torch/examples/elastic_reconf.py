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

The JAX example forces eight host devices; here the pool has eight slot
tokens of one device. The layout a paused tenant's snapshot carries
(``sharding_desc``) is checked against the train state's specs for each
VF's mesh: (2, 1) before the rescale, (4, 2) on all eight slots, (2, 2)
on four.

Run:  PYTHONPATH=src python -m repro_torch.examples.elastic_reconf [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import MeshConfig, make_run_config
from repro_torch.core import DevicePool, SVFFManager, Supervisor, Tenant
from repro_torch.core.snapshot import serialize_specs
from repro_torch.runtime.partitioning import ShardingRules
from repro_torch.train.step import train_state_specs
from repro_torch.tree import flatten

SLOTS = 8


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    return ap


def params_fingerprint(tn) -> float:
    leaf = flatten(tn.export_state()["params"])[0][1][1]
    return float(leaf.double().sum())


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
    pool = DevicePool([f"slot{i}" for i in range(SLOTS)])
    descs = {}
    with tempfile.TemporaryDirectory(prefix="svff_el_") as workdir:
        mgr = SVFFManager(pool, workdir=workdir)

        def pause_and_check(tn):
            mgr.pause(tn)
            snap = mgr.snapshots[tn.tid]
            shape = tuple(snap.mesh_shape)
            descs[shape] = checked_desc(run, snap.sharding_desc, shape,
                                        snap.mesh_axes)

        # 1. single tenant on 2 devices
        a = Tenant("vmA", run, local_batch=2, seq_len=32, seed=0,
                   device=args.device)
        mgr.init(num_vfs=4, tenants=[a], devices_per_vf=2)
        a.run_steps(3)
        print(f"[1] vmA on {pool.find(a.vf_id).mesh_shape} "
              f"steps={a.steps_done}")

        # 2. add a second tenant without disturbing vmA's guest
        fp_before = params_fingerprint(a)
        b = Tenant("vmB", run, local_batch=2, seq_len=32, seed=1,
                   device=args.device)
        mgr.tenants["vmB"] = b
        t = mgr.reconf(num_vfs=4, new_tenants=[b], devices_per_vf=2)
        if abs(params_fingerprint(a) - fp_before) >= 1e-6:
            raise RuntimeError("the reconfiguration changed vmA's params")
        a.run_steps(1)
        b.run_steps(1)
        print(f"[2] reconf added vmB in {t['total']*1000:.0f}ms; "
              f"vmA state preserved, both running")

        # 3. vmB leaves; scale vmA up to all 8 devices
        mgr.detach(b)
        pause_and_check(a)
        pool.set_num_vfs(1, devices_per_vf=8)
        mgr.unpause(a, num_devices=8)
        a.run_steps(2)
        print(f"[3] vmA elastically rescaled to "
              f"{pool.find(a.vf_id).mesh_shape} (8 devices), "
              f"steps={a.steps_done} — state was resharded on unpause")

        # 4. failure -> supervisor migrates via pause machinery.
        #    Scale vmA back to 4 devices so 4 stay free as spares.
        pause_and_check(a)
        pool.set_num_vfs(2, devices_per_vf=4)
        mgr.unpause(a, num_devices=4)
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
        print(f"    layouts checked on meshes {sorted(descs)}")
        mgr.staging.close()
    return {"sharding_desc": descs, "events": kinds,
            "steps_done": a.steps_done}


if __name__ == "__main__":
    main()
