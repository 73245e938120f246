"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to the card:
the port's hot path is its CUDA kernels, so a missing card is an error,
never a quiet fall back to the CPU. Tests pass ``device="cpu"``, where
each kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and this machine "
            "has none; pass device='cpu' to run the plain PyTorch versions")
    return dev
