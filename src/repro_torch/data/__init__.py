"""Deterministic host-sharded data pipeline (mirrors ``repro.data``)."""
