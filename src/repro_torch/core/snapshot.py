"""ConfigSpaceSnapshot — what `pause` saves and `unpause` restores (mirrors
``repro.core.snapshot``).

Paper §IV-B1 step 1: "save the PCI device config space including emulated
config space and MSI state". The analogue of a VF's config space is the
complete logical placement description of the tenant:

  payload        the state tree, staged to host (possibly qdma-packed)
  sharding_desc  the layout spec tree, serialized (how it was laid out)
  mesh_shape/axes the slice geometry it came from
  exec_keys      executable-cache keys (the "MSI state")
  steps_done     progress counters (config registers)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

from repro_torch.core.staging import TransferStats
from repro_torch.tree import flatten


def serialize_specs(spec_tree) -> list:
    """Layout spec tree (tuples of axis names, None or tuples of names per
    dim, as JAX's ``PartitionSpec``s) -> [(path, [axis|None|list]), ...].
    """
    flat, _ = flatten(spec_tree, is_leaf=lambda x: isinstance(x, tuple))
    return [(path, [list(p) if isinstance(p, tuple) else p for p in spec])
            for path, spec in flat]


@dataclasses.dataclass
class ConfigSpaceSnapshot:
    tenant_id: str
    steps_done: int
    payload: Any                       # host-staged state tree
    sharding_desc: list                # serialized spec tree
    mesh_shape: tuple
    mesh_axes: tuple
    exec_keys: list
    created_at: float = dataclasses.field(default_factory=time.time)
    stats: Optional[TransferStats] = None
    compressed: bool = False
    precopy_rounds: int = 0            # >0: taken via pause_vf_live

    def describe(self) -> dict:
        return {
            "tenant_id": self.tenant_id, "steps_done": self.steps_done,
            "mesh_shape": list(self.mesh_shape),
            "mesh_axes": list(self.mesh_axes),
            "exec_keys": [list(k) if isinstance(k, tuple) else k
                          for k in self.exec_keys],
            "bytes": (self.stats.bytes_moved if self.stats else None),
            "compressed": self.compressed,
            "precopy_rounds": self.precopy_rounds,
        }
