"""Roofline model (mirrors ``repro.runtime.roofline``): the injectable
``Peaks``, the three-term ``Roofline`` of a dry-run cell, the per-kernel
achieved-vs-peak report ``kernel_roofline`` (the decode-roofline and
serve-path benchmarks' row shape), ``measure_local_peaks`` and
``model_flops_estimate``.

  compute_s    = flops_per_device / peak_FLOPs
  memory_s     = bytes_per_device / HBM_bw
  collective_s = sum over collectives of bytes_per_device * factor / link_bw

with factor 2 for an all-reduce (reduce-scatter + all-gather) and 1 for
the others, as in the reference. The port's dry-run
(``launch/dryrun.py``) fills the terms from an eager trace on the
``meta`` device and a ring model of the sharding rules' collectives,
where JAX reads XLA's cost analysis and the partitioned HLO.

``Peaks()``'s defaults are the card the port runs on, an NVIDIA H100 SXM5
80 GB (NVIDIA data sheet, dense): 989 TFLOP/s bf16 tensor-core, 3.35 TB/s
HBM3, and 900 GB/s NVLink (all 18 links, both directions) in the field
the reference calls ``ici_bw``, whose key ``peak_ici_bw`` every row
carries. That NVLink rate holds inside one NVLink domain of
``NVLINK_DOMAIN`` cards; ``mesh_peaks`` gives a larger mesh the
inter-node rate of a card instead. A report of "fraction of peak" names
the peaks it used: pass ``measure_local_peaks(device)`` to read
fractions of what the device the benchmark ran on reached, as the JAX
benchmarks do on their CPU backend.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

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

# module-level aliases kept for the reference's callers — canonical values
# live in Peaks so they can be overridden per Roofline / per benchmark
PEAK_FLOPS_BF16 = DEFAULT_PEAKS.flops
HBM_BW = DEFAULT_PEAKS.hbm_bw
ICI_BW = DEFAULT_PEAKS.ici_bw

_AR_FACTOR = 2.0                  # all-reduce = RS + AG

#: cards joined all to all by NVLink in one node (an HGX / DGX H100)
NVLINK_DOMAIN = 8
#: a card's rate off its node: one 400 Gb/s NDR InfiniBand port a GPU, as
#: in NVIDIA's DGX H100 design (DGX H100 user guide: eight ConnectX-7
#: compute ports at 400 Gb/s), 50 GB/s each way
INTER_NODE_BW = 50e9


def mesh_peaks(chips: int, peaks: Peaks = DEFAULT_PEAKS) -> Peaks:
    """``peaks`` for a mesh of ``chips`` cards: NVLink's ``ici_bw`` inside
    one NVLink domain, the inter-node rate a card for a larger mesh (a
    ring over the mesh crosses nodes, and its slowest hop sets its
    pace)."""
    if chips <= NVLINK_DOMAIN:
        return peaks
    return replace(peaks, ici_bw=INTER_NODE_BW)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # per device
    hlo_bytes: float              # per device
    collective_bytes: float       # per device
    collective_detail: dict = field(default_factory=dict)
    model_flops: float = 0.0      # 6*N*D (global, fwd+bwd) or serve analogue
    peaks: Peaks = DEFAULT_PEAKS

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.peaks.flops

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / self.peaks.hbm_bw

    @property
    def collective_s(self) -> float:
        by = self.collective_detail.get("bytes_by_op", {})
        t = 0.0
        for op, b in by.items():
            t += (b * (_AR_FACTOR if op == "all-reduce" else 1.0)
                  / self.peaks.ici_bw)
        if not by:
            t = self.collective_bytes / self.peaks.ici_bw
        return t

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: dominant term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (flops * chips): how much counted compute is
        'useful' (catches remat/redundancy waste)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        denom = self.step_s * self.chips * self.peaks.flops
        return self.model_flops / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "step_s": self.step_s, "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac, "mfu": self.mfu,
            "collective_detail": self.collective_detail,
            **self.peaks.row(),
        }


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
