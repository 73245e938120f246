"""Quickstart: the SVFF framework in ~40 lines (mirrors
``examples/quickstart.py``).

Creates a device pool, partitions it into VFs, attaches two tenant training
jobs, pauses one through the QMP control plane while the pool is
reconfigured, and shows the guest's view throughout. The JAX example
forces eight host devices; here the pool has eight slot tokens of one
device.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import tempfile

from repro_torch.configs import make_run_config
from repro_torch.core import (ControlPlane, DevicePausedError, DevicePool,
                              SVFFManager, Tenant)

SLOTS = 8


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    run = make_run_config("qwen3-0.6b", "train_4k", smoke=True)
    pool = DevicePool([f"slot{i}" for i in range(SLOTS)])
    with tempfile.TemporaryDirectory(prefix="svff_qs_") as workdir:
        mgr = SVFFManager(pool, workdir=workdir)
        qmp = ControlPlane(mgr)

        # --- init: rescan, carve 4 VFs, flash, attach two VMs --------------
        vms = [Tenant("vm0", run, local_batch=2, seq_len=32, seed=0,
                      device=args.device),
               Tenant("vm1", run, local_batch=2, seq_len=32, seed=1,
                      device=args.device)]
        mgr.init(num_vfs=4, tenants=vms, devices_per_vf=2)
        print("pool:", json.dumps(qmp.execute(
            {"execute": "query-vfs"})["return"], indent=1)[:400], "...")

        for vm in vms:
            m = vm.run_steps(3)
            print(f"{vm.tid}: 3 steps, loss={m['loss']:.3f}")

        # --- pause vm0 via QMP (the paper's device_pause command) ----------
        r = qmp.execute({"execute": "device_pause",
                         "arguments": {"id": "vm0"}})
        print("device_pause ->", json.dumps(r["return"]["timings"]))
        print("vm0 guest view while paused:", vms[0].query()["status"],
              "| still sees VF:", vms[0].query()["vf"])
        try:
            vms[0].run_steps(1)
            raise RuntimeError("vm0 ran a step while paused")
        except DevicePausedError as e:
            print("I/O while paused correctly refused:", e)

        # vm1 is untouched the whole time
        vms[1].run_steps(2)

        # --- unpause; vm0 continues where it left off -----------------------
        qmp.execute({"execute": "device_pause",
                     "arguments": {"id": "vm0", "pause": False}})
        m = vms[0].run_steps(2)
        print(f"vm0 resumed: steps_done={vms[0].steps_done}, "
              f"loss={m['loss']:.3f}")

        # --- full reconfiguration cycle (Table II timings) ------------------
        t = mgr.reconf(num_vfs=4, devices_per_vf=2)
        print("reconf timings (ms):",
              {k: round(v * 1000, 1) for k, v in t.items()})
        for vm in vms:
            vm.run_steps(1)
        live = [(vm.tid, vm.steps_done) for vm in vms]
        print("all tenants live after reconf:", live)
        mgr.staging.close()
    return {"steps_done": dict(live), "reconf_ms": {
        k: v * 1000 for k, v in t.items()}}


if __name__ == "__main__":
    main()
