"""The kernel half of the roofline model (mirrors the kernel half of
``repro.runtime.roofline``): the injectable ``Peaks``, the per-kernel
achieved-vs-peak report ``kernel_roofline`` (the decode-roofline and
serve-path benchmarks' row shape), ``measure_local_peaks`` and
``model_flops_estimate``.

``Peaks()``'s defaults are the card the port runs on, an NVIDIA H100 SXM5
80 GB (NVIDIA data sheet, dense): 989 TFLOP/s bf16 tensor-core, 3.35 TB/s
HBM3, and 900 GB/s NVLink (all 18 links, both directions) in the field
the reference calls ``ici_bw``, whose key ``peak_ici_bw`` every row
carries. A report of "fraction of peak" names the peaks it used: pass
``measure_local_peaks(device)`` to read fractions of what the device the
benchmark ran on reached, as the JAX benchmarks do on their CPU backend.

The HLO half of the reference (``Roofline``, ``CollectiveStats``, the
three-term compute/memory/collective model of a dry-run) is not ported
(ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Peaks:
    """Injectable peak-rate constants; defaults: one H100 SXM5 (module
    docstring). Benchmarks and gates pass their own and their rows carry
    the peaks used (``row()``)."""
    flops: float = 989e12         # FLOP/s (bf16, dense)
    hbm_bw: float = 3.35e12       # B/s (HBM3)
    ici_bw: float = 900e9         # B/s (NVLink 4, 18 links, both ways)

    def row(self) -> dict:
        return {"peak_flops": self.flops, "peak_hbm_bw": self.hbm_bw,
                "peak_ici_bw": self.ici_bw}


DEFAULT_PEAKS = Peaks()


def kernel_roofline(name: str, flops: float, bytes_moved: float,
                    wall_s: float, peaks: Peaks = DEFAULT_PEAKS) -> dict:
    """Achieved-vs-peak report for ONE kernel invocation: analytic
    FLOPs/bytes for the kernel, measured wall time, and the achieved
    fractions against ``peaks``. ``bound`` is the analytic bottleneck;
    ``achieved_*_frac`` is what the measurement hit — the gap between
    them is the kernel's headroom."""
    compute_s = flops / peaks.flops if peaks.flops else 0.0
    memory_s = bytes_moved / peaks.hbm_bw if peaks.hbm_bw else 0.0
    ideal_s = max(compute_s, memory_s)
    return {
        "name": name,
        "flops": flops,
        "bytes": bytes_moved,
        "wall_s": wall_s,
        "ideal_s": ideal_s,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "achieved_flops_per_s": flops / wall_s if wall_s else 0.0,
        "achieved_bw": bytes_moved / wall_s if wall_s else 0.0,
        "achieved_bw_frac": (bytes_moved / wall_s / peaks.hbm_bw
                             if wall_s and peaks.hbm_bw else 0.0),
        "peak_frac": ideal_s / wall_s if wall_s else 0.0,
        **peaks.row(),
    }


def _best_s(fn, reps: int, device: torch.device) -> float:
    """The fastest of ``reps`` calls of ``fn`` after one warm call: CUDA
    events around each call on the card (a launch returns before its
    work ends), the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def measure_local_peaks(copy_mb: float = 64.0, reps: int = 3,
                        device="cuda") -> Peaks:
    """Measure the rates ``device`` reaches — elementwise-copy bandwidth
    (one fp32 read and one write of ``copy_mb`` MB) and the FLOP rate of
    a square fp32 matmul — and return them as a ``Peaks``; ``ici_bw``
    keeps the default (no collective to measure). The sizes are the JAX
    function's (64 MB, 512 x 512): on an H100 the copy comes near the
    HBM rate, while a 512² fp32 matmul is far too small (and fp32) to
    show the card's bf16 tensor-core peak, so a caller logs these beside
    the data sheet's ``Peaks()``."""
    dev = resolve_device(device)
    n = max(1, int(copy_mb * 1e6 / 4))
    x = torch.arange(n, dtype=torch.float32, device=dev)
    bw = 2.0 * n * 4 / _best_s(lambda: x + 1.0, reps, dev)
    m = 512
    a = torch.ones((m, m), dtype=torch.float32, device=dev)
    fl = 2.0 * m ** 3 / _best_s(lambda: a @ a, reps, dev)
    return Peaks(flops=fl, hbm_bw=bw, ici_bw=DEFAULT_PEAKS.ici_bw)


def model_flops_estimate(model_cfg, shape_cfg) -> float:
    """MODEL_FLOPS: 6*N_active*D for training; 2*N_active*tokens for
    inference steps (prefill: D=B*S tokens; decode: B tokens)."""
    n_active = model_cfg.active_param_count()
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    if shape_cfg.kind == "train":
        return 6.0 * n_active * B * S
    if shape_cfg.kind == "prefill":
        return 2.0 * n_active * B * S
    return 2.0 * n_active * B          # decode: one token per sequence
