"""SVFF core of the port (mirrors ``repro.core``).

DevicePool (PF) -> VirtualFunction slices -> tenants (VMs), with the
pause/unpause mechanism, init/reconf automation, the QMP-style control
plane, the write-ahead journal and crash recovery, the staging engine
whose kernels run on the card, and the train ``Tenant`` (the guest). The
typed error hierarchy is importable from here (``core.errors`` plus
``core.scheduler`` and ``core.pool``).
"""
from repro_torch.core.errors import (DoubleFreeError, FederationError,
                                     HostUnreachableError, LeaseExpiredError,
                                     ManagerError, SplitBrainError,
                                     UnknownRequestError, UnknownTenantError)
from repro_torch.core.fault import (CrashPlane, HeartbeatMonitor,
                                    InjectedCrash, Supervisor, crash_plane,
                                    crashpoint)
from repro_torch.core.journal import OpJournal
from repro_torch.core.manager import SVFFManager
from repro_torch.core.pause import (PauseError, PhaseTimings, pause_vf,
                                    pause_vf_live, unpause_vf)
from repro_torch.core.pool import DevicePool, PoolError
from repro_torch.core.qmp import ControlPlane
from repro_torch.core.records import RecordStore
from repro_torch.core.scheduler import (AdmissionError, GangPlacementError,
                                        PlacementRequest,
                                        POLICY_NAMES, Scheduler,
                                        make_scheduler)
from repro_torch.core.snapshot import ConfigSpaceSnapshot
from repro_torch.core.staging import StagingEngine, TransferStats
from repro_torch.core.tenant import DevicePausedError, Tenant
from repro_torch.core.vf import VFState, VFTransitionError, VirtualFunction

__all__ = [
    "AdmissionError", "ConfigSpaceSnapshot", "ControlPlane", "CrashPlane",
    "DevicePausedError", "DevicePool", "DoubleFreeError", "FederationError",
    "GangPlacementError", "HeartbeatMonitor", "HostUnreachableError", "InjectedCrash",
    "LeaseExpiredError", "ManagerError", "OpJournal", "PauseError",
    "PhaseTimings", "PlacementRequest", "POLICY_NAMES", "PoolError",
    "RecordStore", "SVFFManager", "Scheduler", "SplitBrainError",
    "StagingEngine", "Supervisor", "Tenant", "TransferStats",
    "UnknownRequestError",
    "UnknownTenantError", "VFState", "VFTransitionError", "VirtualFunction",
    "crash_plane", "crashpoint", "make_scheduler", "pause_vf",
    "pause_vf_live", "unpause_vf",
]
