"""Typed errors of the port's serve path (a copy of the parts of
``repro.core.errors`` that ``serve/paged.py`` needs).

A leaf module: it imports nothing from the package, so every layer can
raise and catch the same classes without import cycles.

    RuntimeError
    ├── DoubleFreeError
    └── UnknownRequestError
"""
from __future__ import annotations


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
