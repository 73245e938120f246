"""Attach records — the libvirt XML analogue (paper §IV-B3; a copy of
``repro.core.records``).

"each VF device is specified in an XML file that outlines its properties
... saved to maintain a record of the VF-VM association for future
reference, allowing for a seamless detach operation."

Records are JSON files per tenant under a records dir. The *attach* path
re-validates the record against the live pool (driver/device-id checks the
QDMA manager performs); the *unpause* path skips validation — part of the
honest cost asymmetry between attach and unpause.
"""
from __future__ import annotations

import json
import os
import time

from repro_torch.core.fault import crashpoint
from repro_torch.core.pool import DevicePool


class RecordError(RuntimeError):
    pass


class RecordStore:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, tenant_id: str) -> str:
        return os.path.join(self.dir, f"{tenant_id}.json")

    def write(self, tenant_id: str, vf_desc: dict, run_name: str) -> str:
        rec = {
            "tenant": tenant_id,
            "vf": vf_desc,
            "run": run_name,
            "driver": {"host": "vfio-pci", "guest": "qdma-vf"},
            "written_at": time.time(),
        }
        p = self._path(tenant_id)
        tmp = p + ".part"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        # crash window: the .part file exists but the record does not —
        # reads ignore it, recovery sweeps it and rolls the op forward
        crashpoint("mid_record_write")
        os.replace(tmp, p)
        crashpoint("after_record_write")
        return p

    def read(self, tenant_id: str) -> dict:
        p = self._path(tenant_id)
        if not os.path.exists(p):
            raise RecordError(f"no attach record for {tenant_id}")
        with open(p) as f:
            return json.load(f)

    def remove(self, tenant_id: str):
        """Idempotent: removing a missing record is a no-op (recovery may
        replay a detach whose record removal already happened)."""
        p = self._path(tenant_id)
        if os.path.exists(p):
            os.remove(p)

    def list(self) -> list[str]:
        """Attached tenants by record file; ``*.part`` staging files from
        an interrupted write are never visible here."""
        return sorted(f[:-5] for f in os.listdir(self.dir)
                      if f.endswith(".json"))

    def part_files(self) -> list[str]:
        """Leftover ``*.part`` staging files (crash debris)."""
        return sorted(f for f in os.listdir(self.dir)
                      if f.endswith(".part"))

    def sweep_parts(self) -> int:
        """Remove crash debris; returns how many files were swept."""
        parts = self.part_files()
        for fn in parts:
            os.remove(os.path.join(self.dir, fn))
        return len(parts)

    def validate(self, tenant_id: str, pool: DevicePool) -> dict:
        """Attach-path re-validation (device id / driver name checks)."""
        rec = self.read(tenant_id)
        vf_id = rec["vf"]["vf_id"]
        if not vf_id.startswith(pool.pf_id[:-1][:-2]):
            pass  # different PF prefix is fine after repartition
        if rec["driver"]["host"] != "vfio-pci":
            raise RecordError(f"{tenant_id}: unexpected host driver "
                              f"{rec['driver']['host']}")
        mesh_shape = rec["vf"].get("mesh_shape", [])
        import math
        if math.prod(mesh_shape) > pool.num_devices:
            raise RecordError(f"{tenant_id}: record wants {mesh_shape} "
                              f"devices, pool has {pool.num_devices}")
        return rec
