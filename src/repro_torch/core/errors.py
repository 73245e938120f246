"""Canonical typed-error hierarchy of the port (a copy of
``repro.core.errors``, which the port may not import).

A leaf module: it imports nothing from the package, so every layer —
core, serve — can raise and catch the same classes without import
cycles. Pool and scheduler admission errors live in their own modules
because they subclass ``PoolError``.

    RuntimeError
    ├── ManagerError
    │   ├── UnknownTenantError
    │   └── FederationError
    │       ├── HostUnreachableError
    │       ├── LeaseExpiredError
    │       └── SplitBrainError
    ├── DoubleFreeError
    └── UnknownRequestError
"""
from __future__ import annotations


class ManagerError(RuntimeError):
    """Typed manager-level rejection."""


class UnknownTenantError(ManagerError):
    """Operation names a tenant the manager holds no state for (e.g.
    unpause of a tenant with no RAM snapshot), typed so callers never have
    to treat a blanket ``KeyError`` as an expected rejection."""


class DoubleFreeError(RuntimeError):
    """``free`` of a rid that holds no pages. With refcounted sharing a
    silent double-decref would corrupt pages still referenced by sibling
    requests, so this is a loud typed error, never a no-op."""


class UnknownRequestError(RuntimeError):
    """``extend``/``cow`` of a rid that holds no pages. The engine's lazy
    decode growth and CoW splits only ever name requests it placed, so an
    unknown rid here is a control-plane bug (stale slot map) — a loud
    typed error, never a silent KeyError/ValueError that callers can't
    distinguish from a malformed argument."""


# --------------------------------------------------------------- federation
class FederationError(ManagerError):
    """Base for cross-host control-plane rejections (a ``ManagerError``,
    so a partition is an expected rejection, never a crash)."""


class HostUnreachableError(FederationError):
    """A cross-host call could not traverse the fabric (network
    partition). Recovery of a cross-host entry defers it instead of
    guessing."""


class LeaseExpiredError(FederationError):
    """An operation was attempted against (or by) a host whose liveness
    lease has lapsed."""


class SplitBrainError(FederationError):
    """A stale coordinator (lease epoch below the host's fence) tried to
    admit or reconfigure."""
