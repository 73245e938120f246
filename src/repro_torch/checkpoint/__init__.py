"""Crash-consistent checkpoint store (mirrors ``repro.checkpoint``)."""
