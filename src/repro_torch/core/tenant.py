"""Tenant-side errors of the port (from ``repro.core.tenant``).

The train ``Tenant`` comes with the training slice (ROADMAP Queue 1 item
4); the serve engine's tenant is ``serve.fleet.EngineTenant``.
"""
from __future__ import annotations


class DevicePausedError(RuntimeError):
    """I/O attempted on a paused device."""
