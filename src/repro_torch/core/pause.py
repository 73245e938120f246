"""The pause / unpause mechanism — the paper's novel contribution (§IV-B1;
mirrors ``repro.core.pause``).

pause (3 steps, mirroring the QEMU vfio-pci implementation):
  1. save the config space — stage the tenant's device state to host
     (StagingEngine = QDMA queues), capture sharding layout, progress
     counters and executable-cache keys (MSI-state analogue);
  2. unregister the PCI device ops — the tenant drops its device handles
     but keeps its emulated view: queries still answered, I/O raises;
  3. unregister the VFIO device — free the device buffers and release the
     VF's devices ("exit from the IOMMU group"), freeing the pool to be
     repartitioned while the guest still sees its (paused) device. A
     torch tensor has no ``delete()``: its memory goes with its last
     reference, so the tenant drops its own in ``suspend`` (an engine
     tenant: params, their compute copy, the page pools) and this step
     drops the exported tree and the staging memo's references.

unpause (2 steps):
  1. restore I/O — reallocate a slice (possibly different devices/shape),
     place the staged state on the tenant's device;
  2. restore config registers — progress counters and executable keys back
     into the tenant; on the same slice the compiled step is a cache hit
     (no re-realize), which is exactly where the paper's ~2% win comes from.

pause_vf_live — the pre-copy variant (QEMU live-migration shape, §Perf
HC5): iterative pre-copy rounds snapshot state to host while the tenant
KEEPS STEPPING (the staging engine's per-tenant memo absorbs each round),
then a final short stop-and-copy moves only the leaves dirtied since the
last round. ``PhaseTimings.stop_ms`` isolates the tenant-visible stall
(the stop-and-copy) from ``total`` (which also counts the background
pre-copy rounds); for plain ``pause_vf`` the two coincide.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

from repro_torch.core.fault import crashpoint
from repro_torch.core.pool import DevicePool
from repro_torch.core.snapshot import ConfigSpaceSnapshot, serialize_specs
from repro_torch.core.staging import StagingEngine
from repro_torch.core.vf import VFState, VirtualFunction


@dataclasses.dataclass
class PhaseTimings:
    phases: dict = dataclasses.field(default_factory=dict)
    #: phases NOT visible to the tenant (pre-copy rounds run while it steps)
    background: set = dataclasses.field(default_factory=set)

    def add(self, name: str, seconds: float, *, stop: bool = True):
        self.phases[name] = self.phases.get(name, 0.0) + seconds
        if not stop:
            self.background.add(name)

    @property
    def total(self) -> float:
        return sum(self.phases.values())

    @property
    def stop_s(self) -> float:
        """Tenant-visible stall in seconds (excludes background phases)."""
        return sum(v for k, v in self.phases.items()
                   if k not in self.background)

    @property
    def stop_ms(self) -> float:
        return self.stop_s * 1e3


class PauseError(RuntimeError):
    pass


def validate_pausable(vf: VirtualFunction, tenant):
    if vf.state != VFState.ATTACHED or vf.owner != tenant.tid:
        raise PauseError(f"{vf.vf_id} not attached to {tenant.tid}")
    if not vf.pausable:
        raise PauseError(f"{vf.vf_id} is not pausable")


def _stop_and_copy(vf: VirtualFunction, tenant,
                   staging: StagingEngine, t: PhaseTimings, *,
                   incremental: Optional[bool] = None,
                   precopy_rounds: int = 0,
                   sink: Optional[dict] = None) -> ConfigSpaceSnapshot:
    """The tenant-visible part of every pause: save config space, then the
    paper's unregister steps. With a warm pre-copy memo the save moves only
    dirty leaves, which is what shrinks ``stop_ms``.

    ``sink`` (the manager's host-RAM snapshot table) is populated BEFORE
    the destructive suspend: from that moment on the snapshot is the
    tenant's second state copy, so a crash after ``tenant.suspend()`` can
    always be rolled forward from it (crash-consistency; see
    ``SVFFManager.recover``)."""
    # -- step 1: save config space (+ MSI state) ---------------------------
    t0 = time.perf_counter()
    state = tenant.export_state()
    payload = staging.save(state, tenant=tenant.tid,
                           incremental=incremental)
    specs = tenant.export_specs()
    snap = ConfigSpaceSnapshot(
        tenant_id=tenant.tid, steps_done=tenant.steps_done, payload=payload,
        sharding_desc=serialize_specs(specs),
        mesh_shape=tuple(vf.mesh_shape), mesh_axes=tuple(vf.mesh_axes),
        exec_keys=list(tenant._exec_cache.keys()),
        stats=staging.last_stats, compressed=staging.compression != "none",
        precopy_rounds=precopy_rounds)
    if sink is not None:
        sink[tenant.tid] = snap
    t.add("save_config_space", time.perf_counter() - t0)
    # crash window: snapshot registered, tenant still running untouched —
    # recovery rolls the pause BACK (drop the snapshot, nothing else moved)
    crashpoint("after_snapshot_register")

    # -- step 2: unregister PCI ops (guest keeps emulated view) -------------
    t0 = time.perf_counter()
    tenant.suspend()
    vf.emulated["status"] = "paused"
    vf.emulated["steps_done"] = tenant.steps_done
    t.add("unregister_pci", time.perf_counter() - t0)
    # crash window: tenant suspended but the VF still ATTACHED holding its
    # devices — recovery rolls the pause FORWARD from the registered snap
    crashpoint("after_suspend")

    # -- step 3: unregister VFIO / exit IOMMU group --------------------------
    t0 = time.perf_counter()
    # the tenant dropped its device tensors in suspend(); the exported
    # tree and the memo's references are the last ones (host copies live
    # in the snap)
    del state
    staging.clear(tenant.tid)
    vf.transition(VFState.PAUSED)
    vf.release_devices()
    t.add("unregister_vfio", time.perf_counter() - t0)
    return snap


def pause_vf(pool: DevicePool, vf: VirtualFunction, tenant,
             staging: StagingEngine,
             sink: Optional[dict] = None) -> tuple[ConfigSpaceSnapshot,
                                                   PhaseTimings]:
    t = PhaseTimings()
    validate_pausable(vf, tenant)
    snap = _stop_and_copy(vf, tenant, staging, t, sink=sink)
    return snap, t


def pause_vf_live(pool: DevicePool, vf: VirtualFunction, tenant,
                  staging: StagingEngine, *, rounds: int = 2,
                  step_fn: Optional[Callable[[], None]] = None,
                  sink: Optional[dict] = None
                  ) -> tuple[ConfigSpaceSnapshot, PhaseTimings]:
    """Pre-copy live pause. ``rounds`` background snapshot rounds run while
    the tenant keeps working (``step_fn`` is the tenant's own stepping,
    invoked between rounds to model concurrent progress); the final
    stop-and-copy then moves only leaves dirtied since the last round.
    Requires nothing of the tenant beyond the usual pause protocol.
    ``rounds`` is clamped to >= 1: a live pause with no background round
    is just ``pause_vf``, and would trip invariant I7's
    "live pause ran no background pre-copy" check."""
    t = PhaseTimings()
    validate_pausable(vf, tenant)
    rounds = max(1, rounds)
    for r in range(rounds):
        t0 = time.perf_counter()
        staging.save(tenant.export_state(), tenant=tenant.tid,
                     incremental=True)
        t.add(f"precopy_{r}", time.perf_counter() - t0, stop=False)
        # crash window: a pre-copy round landed in the memo, nothing
        # guest-visible moved — recovery discards the memo and rolls back
        crashpoint("mid_precopy_round")
        if step_fn is not None:
            step_fn()             # tenant work: not part of the pause at all
    snap = _stop_and_copy(vf, tenant, staging, t, incremental=True,
                          precopy_rounds=rounds, sink=sink)
    return snap, t


def unpause_vf(pool: DevicePool, vf: VirtualFunction, tenant,
               snap: ConfigSpaceSnapshot, staging: StagingEngine,
               num_devices: int | None = None) -> PhaseTimings:
    t = PhaseTimings()
    if vf.state != VFState.PAUSED:
        raise PauseError(f"{vf.vf_id} is not paused")

    # -- step 1: restore I/O connections --------------------------------------
    t0 = time.perf_counter()
    if not vf.devices:
        pool.allocate(vf, num_devices or math.prod(snap.mesh_shape))
    # crash window: devices (re)allocated but nothing restored — recovery
    # rolls BACK (release the devices, keep the snapshot, stay paused)
    crashpoint("before_unpause_restore")
    # the restore ends with a synchronize: the state is on the device
    state = staging.restore(snap.payload, tenant.shardings_for(vf))
    vf.transition(VFState.ATTACHED)
    # crash window: VF back to ATTACHED but the tenant not yet resumed —
    # recovery rolls FORWARD (redo the restore from the retained snapshot)
    crashpoint("after_unpause_restore")
    t.add("restore_io", time.perf_counter() - t0)

    # -- step 2: restore config registers --------------------------------------
    t0 = time.perf_counter()
    tenant.steps_done = snap.steps_done
    tenant.resume(state, vf)
    vf.emulated["status"] = "running"
    t.add("restore_config", time.perf_counter() - t0)
    return t
