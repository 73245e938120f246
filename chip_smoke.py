#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU: build its CUDA kernels from this checkout, hold each against its
plain PyTorch version at the main paths' full-width shapes, then serve
qwen3-0.6b at full width (28 layers, d_model 1024, 16/8 heads of 128,
vocab 151,936; random weights from ``--seed``) through the paged
``ServeEngine`` with bf16 and with int8 KV pages, and through a
``ServeFleet`` of two engine tenants under the SVFF manager, reconfigured
mid-traffic (live pause, reconf through pause and through detach/attach,
migrate) with the bit-exact staging engine and with the int8 one. Then
the elastic fleet at the same width: requests live-migrated between the
two engines mid-decode (bf16 and int8 KV pages), a busy engine scaled in
(its in-flight requests migrated), a crashed engine's requests re-homed
and regenerated, and the JAX elastic benchmark's static-vs-autoscaled
fleets over four traffic traces (and again at the smoke width on the CPU,
for the action sequence). Then the serve plane at the same width: the
dense per-slot KV ring (``ServeEngine(paged=False)``) serving the same
16 requests, and the JAX package's serve-plane benchmarks through the
port's benchmarks (``bench.serve_path``, ``bench.prefix_share``,
``bench.decode_roofline`` at bf16 against the H100's data sheet,
``bench.throughput`` on svff-bench and a qwen3-0.6b train tenant). Then
the pipeline-parallel engines at the same width: ``PipelineServeEngine``
at K = 1-4 stages (two microbatch groups, host sampling) serving the 16
requests token-identically to the single-stage paged engine, a K=4 gang
narrowed live to 3 and 2 mid-decode, an int8-KV gang at K=2, a
``ServeFleet`` of gang engines whose ``attach_group``, ``reshape_engine``
2 -> 3, ``handle_vf_loss`` 3 -> 2 and a gang lead's live pause leave
every stream equal to the undisturbed fleet's (then two int8 pauses of
gang leads), the sim plane's reshape scenarios, and
``bench.pipeline_serve``. Then the federation at the same width: two
``Host``s under one ``FederationCoordinator``, each with one paged bf16
engine, requests moved between them mid-decode through the journaled
cross-host ``migrate_request`` (8 clean in both directions, 3 under
``fed_migrate_mid_ship`` rolled back and 3 under
``fed_migrate_after_admit`` rolled forward after a heal and a recovery,
an ownership witness at every step, the streams equal to the paged bf16
engine's), a two-engine fleet's ``federation_snapshot``, federation
scenarios and the 210-cell network-fault matrix with the sim state on
the card (each scenario equal to its CPU run), and ``bench.federation``
at the JAX artifact's scale (8 hosts x 256 engines, 120,000 requests; a
host-side driver whose digests equal the JAX benchmark's). Then the
distributed runtime: four ranks spawned on the card under gloo, the
int8-compressed gradient all-reduce of fp32 replicas shaped like
qwen3-0.6b's params (``qdma_pack`` / ``qdma_unpack`` on every rank; the
ranks bit-equal to each other and to the plain pack and unpack, each
leaf within the JAX test's bound of the fp64 mean) and ``pipeline_apply``
of qwen's 28 layers as 4 stages over 8 microbatches (bit-equal to the
stages run one after another), then the port's four examples. Then the
dry-run against the card: qwen3-0.6b's ``decode_32k`` at B = 8 (a 30 GB
bf16 cache through ``flash_decode``), ``prefill_32k`` at B = 2 (through
``flash_attention``) and ``train_4k`` at B = 2 (remat, AdamW), each
counted on the unit mesh by the port's ``launch.dryrun.run_cell`` and
then run for real: the step no faster than its counted bound and its
peak memory at least the counted argument bytes. Then fp32 compute:
the four attention kernels on fp32 inputs (flash_attention and the
paged decode over fp32 pages as 3xTF32 products on the tensor cores, the
paged decode over int8 pages as three bf16 pieces of q and P on them,
flash_decode as CUDA-core FMA) against their
plain versions within JAX's fp32 tolerance 2e-5, and qwen3-0.6b at
``PrecisionConfig(compute="float32")`` through them: prefill logits
within 1e-3 of the plain fp32 path's (every layer's attention the
tensor-core kernel, by its device name), the 16 requests through the paged
engine with fp32 pages, with int8 pages and through the dense ring (each
stream the plain engine's, fused == host sampling), the generate path
within 1e-3 and the eval loss within 1e-5 of the plain path. Then the
hybrid Mamba-attention stack, jamba-1.5-large-398b-1p-dense (one period
of Jamba-1.5-Large at every published width, 1 attention and 7 mamba
layers, dense FFNs, bf16 params, random weights from ``--seed``):
prefill logits through the kernels against the plain versions, the paged
``ServeEngine`` with bf16 and int8 KV pages, and the uniform-position
generate path of ``make_serve_steps`` against the teacher-forced forward.
Then training at qwen3-0.6b's full width: 30 steps of
``repro_torch.launch.train``, a train ``Tenant`` paused, unpaused and reconfigured under the
SVFF manager against its undisturbed twin, an int8 pause of it, the eval
step through ``flash_attention`` against the plain train-mode loss, and
the paper's Tables I and II. Then the train tenant sharded over its VF's
mesh: a ``RankPool`` of four gloo ranks on the card, a qwen3-0.6b tenant
at full width cut to 4 layers on 2-rank VFs, paused, repartitioned and
unpaused onto (2, 2) with plain staging, then back onto (2, 1) with int8
staging (packed, digested and unpacked on the ranks), against the same
tenant on one device, and ``launch.train`` on a 2-rank world against one
rank. Then the other model families, one at a
time with random weights from ``--seed``, each model's params freed
before the next is built: olmoe-1b-7b at full width cut to 4 of its 16
layers (d_model 2,048, 16/16 heads of 128, 64 experts top-8) on the dense ring,
paged bf16 and paged int8 engines (16 requests of 5-512 tokens, and a
600-token prompt rejected by the MoE group rule), llama3-8b and
phi3-mini-3.8b (head dim 96) on paged engines, xlstm-350m (its generate
path against the forward, the sLSTM's token loop timed, the dense ring),
seamless-m4t-medium (random frames through the non-causal kernel, the
dense ring with its cross KV), internvl2-1b (256 random patches, dense
and paged), arctic-480b-1l (one layer of Arctic at every published
width, 128 experts top-2 beside a dense FFN, 14.07 B bf16 params) and
jamba-1.5-large-398b at its smoke widths with its experts (MoE beside
mamba on ``ssm_scan``): each a prefill-logits check through the kernels
against the plain versions at fp32 compute, and the serve phases'
checks on each engine. Last, the sim plane with every tenant's state on
the card: the 19 crash points x seeds 0-2 x three policies, the pause
path (HC1-HC5) on the ~918 MB qwen3-100m-bench train state, whose int8
rows launch ``qdma_pack``, ``qdma_pack_rows`` and ``qdma_unpack``, and
the scenario sweep (24 ops, 16 devices, leaf 16, three policies; a
default pass and a serve 0.3 / crash 0.1 pass, every invariant after
every op), whose seed counts fill their budgets.

The groups are read in that order, but not all run in this process one
after another. Two lanes, each a spawned process, start beside the qwen
serve group: the host lane runs the host-bound sim and federation jobs
(the elastic sweep's CPU run, reshape scenarios, fed scenarios,
network-fault matrix, ``bench.federation``, crash matrix, sweeps), the model lane the hybrid
group and then the families group; each group reads its lane's results
where it stands in the order, with the lane's launch counts. The
distributed group's four ranks start beside the federation group, the
elastic example beside the serve plane group, ``launch.train`` on 2
ranks and the sharded group's ``RankPool`` beside the train group. The per-kernel
timings run before anything starts beside them.

    python3 chip_smoke.py            # from the repository root

Phases: card, build, one phase per kernel, qwen serve (bf16, int8), SVFF
(bit-exact staging, int8 staging), elastic (migration bf16 and int8,
scale-in, recovery, elastic sweep), serve plane (dense ring, serve path,
prefix share, decode roofline, throughput x2), pipeline (gang engines
K=1-4, live reshape, int8 gang, gang fleet, reshape scenarios, pipeline
bench), federation (cross-host engines, federation snapshot, fed
scenarios, network-fault matrix, federation bench), distributed
(collectives, pipeline_apply, examples), dry-run (decode, prefill and
train cells against their counts), fp32 (the four kernels at fp32,
prefill, serve fp32/int8/dense, generate, eval), hybrid prefill,
hybrid serve (bf16, int8), hybrid generate, train launch, train tenant
(bit-exact, int8), eval step, Tables I/II, spmd (sharded tenant, plain
and int8 reshards, launch.train on 2 ranks), families (per model: prefill,
serve on its engines; olmoe's group rule, xlstm's generate path), crash
matrix, pause path, sim sweep (two passes), kernels line, result line.
Any failed check exits non-zero before the result line. Details go to
``chiprun_out/chip_smoke.json``. The script imports only torch, numpy and
the port.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
# fp32 flash_attention's and the fp32 paged decode's rate: each product as
# three TF32 products on the tensor cores (3xTF32)
FP32_ATTN_FLOP_PER_S = TF32_FLOP_PER_S / 3
# the int8 paged decode's under fp32 q: three bf16 products a product (q's
# and P's three bf16 pieces against exact int8 values)
FP32_QUANT_FLOP_PER_S = BF16_FLOP_PER_S / 3

# tolerances, each with its reason (the readings they were set from are
# in PERF.md)
ATTN_RTOL = 2 ** -6    # attention outputs, elementwise: |kernel - plain| <=
ATTN_ATOL = 1e-4       # ATTN_ATOL + ATTN_RTOL * |plain|, two bf16 steps of
                       # the value. Kernel and plain version each round an
                       # fp32 result to bf16 once, after sums taken in other
                       # orders, so they may differ by one step
LOGITS_REL_TOL = 1.5e-2  # qwen's prefill logits, kernel path vs plain
                         # path, over 28 bf16 layers, relative to max
                         # |logit|
HYBRID_MARGIN = 1.5      # the hybrid's prefill: the kernel path's distance
                         # from the plain path with fp32 compute, at most
                         # this many times the plain bf16 path's own, for
                         # the logits (of max |logit|) and for the mean
                         # over mamba layers of the final SSM state's (of
                         # its max). Both paths round the same bf16 stack
                         # in other orders, so they lie about as far from
                         # fp32: 0.83-1.13 times over seeds 0-3 (the
                         # readings, and what the limit rejects, are in
                         # PERF.md)
SSM_REL_TOL = 1e-4       # ssm_scan y and state vs the plain version,
                         # relative to max |plain|. The plain version
                         # computes in fp32; the kernel's tensor-core
                         # products take each fp32 operand as a bf16 pair
                         # (about 2**-16 of its value) and sum in fp32 in
                         # other orders: 0.03-0.08 of the limit, emulated
                         # (tests/test_torch_ssm.py::test_ssm_scan_numerics)
GEN_REL_TOL = 5e-2       # the generate path's logits vs one teacher-
                         # forced forward, relative to max |logit| (the
                         # JAX package's bound, tests/test_models.py)

# fp32 operations per vocab entry of the fused sampler's noise + argmax
# (mix: 10 integer ops; two portable logs of 18 float ops; 4 more)
SAMPLE_OPS_PER_NOISY = 50
SAMPLE_OPS_PER_GREEDY = 2

# the staging kernels: the compressed pause's block (the page pools' last
# dim is head_dim 128, so block 256 would pack none of them), and the
# operations each does per element, counted at the fp32 CUDA-core rate
# (pack: abs, max, divide, round, two clamps; unpack: convert, multiply;
# digest: per byte, a quarter of two dp4a and the two weight products)
QDMA_BLOCK = 128
PACK_OPS, UNPACK_OPS, DIGEST_OPS_PER_BYTE = 6, 2, 1
# the int8 staging bound: |x - unpack(pack(x))| <= scale * (1/2 + 2**-16)
# (half a step, plus the roundings of x / scale and q * scale, each at
# most 127 * scale * 2**-24), plus, for a bf16 leaf, the rounding of the
# restored value to bf16 (8 significant bits: at most 2**-8 of the value
# before rounding, which is at most (1 + 2**-7) times the value after)
INT8_SLACK = 2 ** -16
BF16_HALF_STEP = 2 ** -8 * (1 + 2 ** -7)


SERVE_KERNELS = ("flash_attention", "paged_decode", "paged_decode_quant",
                 "fused_sample")
HYBRID = "jamba-1.5-large-398b-1p-dense"
HYBRID_SERVE_KERNELS = SERVE_KERNELS + ("ssm_scan",)
GENERATE_KERNELS = ("flash_attention", "ssm_scan", "flash_decode")
QDMA_KERNELS = ("qdma_pack", "qdma_pack_rows", "qdma_unpack", "qdma_digest")
#: the __global__ functions of qdma_pack.cu in the profiler's names
STAGING_KERNEL_NAMES = re.compile(
    r"\b(pack_kernel|pack_any_kernel|unpack_kernel|digest_kernel)\b")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


#: (seconds on this process's clock, the line's start) of every logged
#: line, into ``chip_smoke.json`` as "log_times": where the script's time
#: goes
LOG_TIMES = []
LOG_T0 = time.perf_counter()


def log(msg: str):
    print(msg, flush=True)
    LOG_TIMES.append((round(time.perf_counter() - LOG_T0, 1), msg[:72]))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
#: a spin of ~0.5 ms ahead of each timed call: longer than the host takes
#: to enqueue one wrapper's launches
SLEEP_CYCLES = 1_000_000


class Timer:
    """Median device time of one call, by CUDA events around each call,
    with the 50 MB L2 cache flushed before every call (the serve path
    reads each layer's weights and pages once per step, cold) and the
    card kept busy while the host enqueues the call."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, reps: int = 25, warm: int = 3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            # keep the card busy while the host enqueues ``fn``'s work, so
            # the events time the device and not the host's dispatch
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def attn_err(got, want, atol=ATTN_ATOL, rtol=ATTN_RTOL):
    """(max |got - want|, the largest share of its limit atol + rtol *
    |want| that any element uses; the check is share <= 1)."""
    d = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    return float(d.max()), float((d / lim).max())


def bound(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------
def family_attention_shapes(get):
    """The other families' prefill attention shapes, (S, T, H, K, hd,
    causal, who) from their full configs (``get(arch)``): phi3-mini's hd
    96 at qwen's S 384 and longest prompt 600; seamless's encoder (S = T)
    and cross attention (T = S / 4), not causal; internvl2's 256 patches
    + 384 tokens at G = 7; arctic's 56/8 heads."""
    phi3, seam = get("phi3-mini-3.8b"), get("seamless-m4t-medium")
    vl, arctic = get("internvl2-1b"), get("arctic-480b-1l")
    out = [(S, S, phi3.num_heads, phi3.num_kv_heads, phi3.head_dim, True,
            "phi3-mini") for S in (384, 600)]
    out += [(384, 384, seam.num_heads, seam.num_kv_heads, seam.head_dim,
             False, "seamless encoder"),
            (384, 96, seam.num_heads, seam.num_kv_heads, seam.head_dim,
             False, "seamless cross"),
            (640, 640, vl.num_heads, vl.num_kv_heads, vl.head_dim, True,
             "internvl2, 256 patches + 384"),
            (384, 384, arctic.num_heads, arctic.num_kv_heads,
             arctic.head_dim, True, "arctic")]
    return out


def phase_flash_attention(torch, ops, timer, cfg, hcfg, families=()):
    """flash_attention at qwen3-0.6b's prompt lengths (S 7, 200, 384 and
    its longest, 600; 16/8 heads of 128), at the hybrid's prefill shape
    (S 512, 64/8 heads of 128), at the other families' (``families``:
    hd 96, G 1 and 7, not causal, T != S) and at the dry-run's prefill
    cell's (``flash_attention_32k_row``)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    hd = cfg.head_dim
    shapes = [(S, S, cfg.num_heads, cfg.num_kv_heads, hd, True, None)
              for S in (7, 200, 384, 600)]
    shapes.append((512, 512, hcfg.num_heads, hcfg.num_kv_heads, hd, True,
                   None))
    shapes += list(families)
    for S, T, H, K, hd, causal, who in shapes:
        q = torch.randn((1, S, H, hd), generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((1, T, K, hd), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in "kv")
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention(q, k, v, causal=causal, backend="ref")
        torch.cuda.synchronize()
        err, share = attn_err(got, want)
        label = f"q (1,{S},{H},{hd}) k/v {K} heads" + (
            f" T={T}" if T != S else "") + (f" ({who})" if who else "")
        check(share <= 1, f"flash_attention {label}: max_abs_err {err}, "
                          f"{share:.3g} of the limit")
        check(torch.equal(got, ops.flash_attention(q, k, v, causal=causal)),
              f"flash_attention {label}: not deterministic")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        ms = timer.ms(lambda: ops.flash_attention(q, k, v, causal=causal))
        plain = timer.ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                     backend="ref"))
        nbytes = 2 * (2 * S * H * hd + 2 * T * K * hd)   # q, o, k, v bf16
        pairs = S * (S + 1) / 2 if causal else S * T      # (query, key)
        flops = 4 * H * hd * pairs                        # QK^T + PV
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        rows.append({"shape": f"{label} bf16, "
                              f"{'causal' if causal else 'not causal'}",
                     "max_abs_err": err, "share_of_limit": share,
                     "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        log(f"flash_attention {label}: max_abs_err {err:.3g} ({share:.3g} "
            f"of the limit) | kernel {ms:.4f}"
            f" ms | plain {plain:.4f} ms | sdpa {lib:.4f} ms | bound "
            f"{b_ms:.4f} ms ({b_by})")
    rows.append(flash_attention_32k_row(torch, ops, timer, cfg))
    return rows


#: the dry-run's prefill cell's attention: prefill_32k at B = 2; the plain
#: version is held on the last PLAIN_ROWS query rows against every key
#: (the whole plain attention would hold ~68 GB of fp32 scores)
PREFILL_32K = (2, 32768)
PLAIN_ROWS = 256


def plain_attention_rows(torch, q, k, v, first: int):
    """The plain causal attention (``flash_attention_ref``'s numerics:
    fp32 scores, softmax and PV, one rounding to bf16) of query rows
    ``first``.. of q against every key, row i seeing keys j <= i."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q[:, first:].reshape(B, S - first, K, H // K, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) / math.sqrt(hd)
    rows = torch.arange(first, S, device=q.device)[:, None]
    logits = logits.masked_fill(torch.arange(T, device=q.device) > rows,
                                -1e30)
    o = torch.einsum("bkgst,btkh->bskgh", torch.softmax(logits, dim=-1),
                     v.float())
    return o.reshape(B, S - first, H, hd).to(q.dtype)


def flash_attention_32k_row(torch, ops, timer, cfg):
    """flash_attention at the dry-run prefill cell's shape, q (2,32768,16,
    128) causal with 8 KV heads, its last ``PLAIN_ROWS`` rows held against
    the plain version of those rows; the kernel and SDPA timed on the
    whole, the plain version on those rows."""
    import torch.nn.functional as F
    (B, S), H, K, hd = PREFILL_32K, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(32)
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, S, K, hd), generator=g, device="cuda")
            .bfloat16() for _ in "kv")
    first = S - PLAIN_ROWS
    got = ops.flash_attention(q, k, v, causal=True)
    want = plain_attention_rows(torch, q, k, v, first)
    torch.cuda.synchronize()
    err, share = attn_err(got[:, first:], want)
    label = f"q ({B},{S},{H},{hd}) k/v {K} heads"
    check(share <= 1, f"flash_attention {label}: max_abs_err {err} on the "
                      f"last {PLAIN_ROWS} rows, {share:.3g} of the limit")
    check(bool(torch.isfinite(got).all()),
          f"flash_attention {label}: non-finite output")
    # SDPA on the KV heads repeated to H, its flash backend only: a
    # fallback to the math backend would hold the whole score matrix
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), reps=5, warm=1)
    del qt, kt, vt
    ms = timer.ms(lambda: ops.flash_attention(q, k, v, causal=True),
                  reps=5, warm=1)
    plain = timer.ms(lambda: plain_attention_rows(torch, q, k, v, first),
                     reps=5, warm=1)
    nbytes = B * 2 * (2 * S * H * hd + 2 * S * K * hd)
    flops = 4 * B * H * hd * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    log(f"flash_attention {label}: max_abs_err {err:.3g} ({share:.3g} of "
        f"the limit, last {PLAIN_ROWS} rows) | kernel {ms:.4f} ms | plain "
        f"{plain:.4f} ms ({PLAIN_ROWS} rows) | sdpa {lib:.4f} ms | bound "
        f"{b_ms:.4f} ms ({b_by})")
    return {"shape": f"{label} bf16, causal (prefill_32k, B={B}; plain on "
                     f"the last {PLAIN_ROWS} rows)",
            "max_abs_err": err, "share_of_limit": share, "ms": ms,
            "plain_ms": plain, "plain_rows": PLAIN_ROWS, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib}


#: the paged phase's positions: the full view, inactive, mid-page, a page
#: edge, the first token, ... (the timed shape)
PAGED_POS = (1023, -1, 600, 15, 0, 384, 200, -1)


def paged_serve_positions(vocab: int, seed: int) -> list:
    """Every slot active: the first eight prompts of the qwen serve draw
    (``make_requests``), each 16 tokens into its decode."""
    from repro_torch.serve.engine import Request
    return [len(r.prompt) - 1 + 16
            for r in make_requests(Request, vocab, seed)[:8]]


def paged_cases(cfg, hcfg, seed: int) -> list:
    """(label, query heads, positions) of the paged phase: qwen3-0.6b's
    heads at PAGED_POS (the main row), the hybrid's 64 query heads on the
    same 8 KV heads, and qwen's with every slot active."""
    return [("qwen heads", cfg.num_heads, PAGED_POS),
            ("hybrid heads", hcfg.num_heads, PAGED_POS),
            ("all slots", cfg.num_heads,
             paged_serve_positions(cfg.vocab_size, seed))]


def paged_inputs(torch, H, K, hd, positions, seed, quant: bool,
                 dtype=None):
    """The serve engine's pool at B=8, page 16, NP 64 (max_len 1,024) and
    one page of garbage: q (8,1,H,hd) and the pages (513,16,K,hd) in
    ``dtype`` (bf16 by default), each slot's table a distinct run of a
    seeded permutation. Returns the kernel's arguments (int8 pages with
    their fp32 scales when ``quant``)."""
    from repro_torch.kernels.ref import kv_quant_ref
    B, page, NP = 8, 16, 64
    P = 1 + B * NP
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = dtype or torch.bfloat16
    q = torch.randn((B, 1, H, hd), generator=g, device="cuda").to(dtype)
    kp = torch.randn((P, page, K, hd), generator=g, device="cuda")
    vp = torch.randn((P, page, K, hd), generator=g, device="cuda")
    perm = np.random.default_rng(seed).permutation(np.arange(1, P))
    tables = torch.tensor(perm.reshape(B, NP).astype(np.int32),
                          device="cuda")
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    if quant:
        kq, ks = kv_quant_ref(kp)
        vq, vs = kv_quant_ref(vp)
        return q, kq, vq, ks, vs, tables, pos
    return q, kp.to(dtype), vp.to(dtype), tables, pos


def paged_work(q, kp, tables, pos, quant: bool):
    """(bytes, flops) of one call: q, the rows up to pos[b] of K and V
    (with their fp32 scales for int8 pages), tables and pos read once,
    the output written once, each at its width; 4 flops per query head
    and element read."""
    B, _, H, hd = q.shape
    K = kp.shape[2]
    rows = int((pos + 1).clamp(min=0).sum())
    row_bytes = 2 * (hd * kp.element_size() + (4 if quant else 0))
    nbytes = (rows * K * row_bytes + 2 * q.element_size() * B * H * hd
              + tables.numel() * 4 + pos.numel() * 4)
    return nbytes, 4 * H * hd * rows


def phase_paged_decode(torch, ops, timer, cfg, hcfg, seed):
    """Both paged kernels at each of ``paged_cases``, bf16 and int8 pages:
    within the limit of the plain version, inactive rows exactly zero,
    the same bits on a second call. One call of each puts exactly one
    kernel on the card (one profiler session)."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    out = {"paged_decode": [], "paged_decode_quant": []}
    first = {}
    for label, H, positions in paged_cases(cfg, hcfg, seed):
        for quant in (False, True):
            name = "paged_decode_quant" if quant else "paged_decode"
            fn = getattr(ops, name)
            args = paged_inputs(torch, H, K, hd, positions, 12 + quant,
                                quant)
            q, kp, tables, pos = args[0], args[1], args[-2], args[-1]
            got, want = fn(*args), fn(*args, backend="ref")
            torch.cuda.synchronize()
            err, share = attn_err(got, want)
            where = f"{name} {label}"
            check(share <= 1, f"{where}: max_abs_err {err}, {share:.3g} of "
                              "the limit")
            inactive = (pos < 0).nonzero().flatten()
            check(bool(torch.all(got[inactive] == 0)),
                  f"{where}: an inactive slot's row is not exactly zero")
            check(torch.equal(got, fn(*args)), f"{where}: not deterministic")
            ms = timer.ms(lambda: fn(*args))
            plain = timer.ms(lambda: fn(*args, backend="ref"))
            nbytes, flops = paged_work(q, kp, tables, pos, quant)
            b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
            log(f"{where} q {tuple(q.shape)}: max_abs_err {err:.3g} "
                f"({share:.3g} of the limit) | kernel {ms:.4f} ms | plain "
                f"{plain:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
            out[name].append({
                "shape": f"{label}: q {tuple(q.shape)}, pages (513,16,{K},"
                         f"{hd}) {'int8' if quant else 'bf16'}, NP=64, pos "
                         f"{list(positions)}",
                "max_abs_err": err, "share_of_limit": share, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None})
            first.setdefault(name, (fn, args))
    one_kernel_each(torch, [lambda fn=fn, args=args: fn(*args)
                            for fn, args in first.values()], "paged_decode")
    return out


def sample_inputs(torch, cfg):
    """The sampler phase's batch at ``cfg``'s padded vocabulary: logits
    (8, Vp) fp32, temperatures, top-k and keys (seed, rid, counter) of
    greedy, temperature and top-k rows."""
    from repro_torch.models.params import padded_vocab
    g = torch.Generator(device="cuda").manual_seed(13)
    logits = torch.randn((8, padded_vocab(cfg)), generator=g,
                         device="cuda") * 3
    temp = torch.tensor([0, .8, .8, 1.5, 0, .8, .3, 1.], device="cuda")
    top_k = torch.tensor([0, 0, 50, 0, 0, 1, 50, 100], dtype=torch.int32,
                         device="cuda")
    keys = torch.randint(0, 2**31 - 1, (8, 3), generator=g, device="cuda",
                         dtype=torch.int32)
    return logits, temp, top_k, keys


def phase_fused_sample(torch, ops, timer, cfg, hcfg, *more):
    """The sampler at qwen3-0.6b's padded vocabulary (the main row), the
    hybrid's and those of ``more`` configs (seamless's 256,256, the
    widest), B = 8 (greedy, temperature, top-k rows): bit-exact against
    the plain version, and one call puts one kernel on the card (one
    profiler session)."""
    from repro_torch.kernels.sampling import prepare_rows
    rows, calls = [], []
    for c in (cfg, hcfg) + more:
        logits, temp, top_k, keys = sample_inputs(torch, c)
        V, (B, Vp) = c.vocab_size, logits.shape
        got = ops.fused_sample(logits, temp, top_k, keys, vocab_size=V)
        want = ops.fused_sample(logits, temp, top_k, keys, vocab_size=V,
                                backend="ref")
        check(torch.equal(got, want), f"fused_sample Vp={Vp}: {got.tolist()}"
                                      f" != {want.tolist()} (must be "
                                      "bit-exact)")
        z, noisy = prepare_rows(logits, temp, top_k, vocab_size=V)
        keys4 = torch.cat([keys, noisy.int()[:, None]], 1).contiguous()
        check(torch.equal(ops.sample_rows(z, keys4), got),
              f"fused_sample Vp={Vp}: not deterministic")
        ms = timer.ms(lambda: ops.sample_rows(z, keys4))
        plain = timer.ms(lambda: ops.sample_rows(z, keys4, backend="ref"))
        n_noisy = int(noisy.sum())
        nbytes = B * Vp * 4 + keys4.numel() * 4 + B * 4
        flops = Vp * (n_noisy * SAMPLE_OPS_PER_NOISY
                      + (B - n_noisy) * SAMPLE_OPS_PER_GREEDY)
        b_ms, b_by = bound(nbytes, flops, FP32_FLOP_PER_S)
        log(f"fused_sample B={B} Vp={Vp}: bit-exact | kernel {ms:.4f} ms | "
            f"plain {plain:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
        rows.append({"shape": f"z ({B},{Vp}) fp32", "max_abs_err": 0.0,
                     "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
        calls.append(lambda z=z, keys4=keys4: ops.sample_rows(z, keys4))
    one_kernel_each(torch, calls, "fused_sample")
    return rows


def one_kernel_each(torch, calls, name):
    """Check, in one profiler session, that each call puts exactly one
    kernel on the card, one of ``name``'s."""
    names, lead = device_kernels(torch, calls)
    check(len(names) == len(calls) and all(name in n for n in names),
          f"{name}: {len(calls)} calls put {names} on the card, not one "
          "kernel each")
    log(f"{name}: {len(calls)} calls put {len(names)} kernels on the card, "
        f"all {name} (the card's lead over the host clock {fmt_ms(lead)})")


#: torch.cuda._sleep cycles on either side of a profiled region: ~20 ms
#: at the H100's clock. Kineto keeps only the device events that lie
#: inside the session's window on the host's clock; in a process that has
#: run for minutes the card's timestamps can lead that clock by a
#: millisecond or more, and the session's first device events then fall
#: before the window and are dropped (PERF.md §7). The sleeps take that
#: loss, and the region's own events lie well inside.
PROFILE_PAD_CYCLES = 40_000_000
#: and short spins launched after that first sleep, then waited for: a
#: session also drops the device records of the first few dozen launches
#: after the sleep's synchronize, whatever the sleep's length (on the
#: H100: 41-57 launches, ~4-5 ms, more in an older process; the hybrid's
#: generate step then lost its flash_decode record). The spins take that
#: loss: more launches, and a longer span, than it took.
PROFILE_SPINS = 128
PROFILE_SPIN_CYCLES = 150_000


def profiled(torch, fn, pad: int = PROFILE_PAD_CYCLES):
    """Run ``fn`` in one torch.profiler session between two device
    sleeps of ``pad`` cycles, the first waited for and followed by
    PROFILE_SPINS short spins, waited for too. Returns (fn's result,
    the names of the device events the region put on the card, kernels,
    copies and memsets alike, the sleeps and spins left out, and the
    card's lead in ms: the most any of fn's device events' start precedes
    the start of its own launch call on the host, matched by correlation
    id. fn's first launches find the card idle, so their work starts microseconds after
    the call: the lead is that much below 0 where the two clocks agree,
    and above 0 by about their disagreement where the card's leads. None
    where no launch was matched)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(pad)
        torch.cuda.synchronize()
        for _ in range(PROFILE_SPINS):
            torch.cuda._sleep(PROFILE_SPIN_CYCLES)
        torch.cuda.synchronize()        # fn's launches find the card idle
        out = fn()
        torch.cuda._sleep(pad)
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events()
             if e.device_type == dev and "spin_kernel" not in e.name]
    raw = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in raw
              if e.device_type() != dev and e.name().startswith("cuda")}
    leads = [launch[e.correlation_id()] - e.start_ns() for e in raw
             if e.device_type() == dev and e.correlation_id() in launch
             and "spin_kernel" not in e.name()]
    return out, names, (max(leads) / 1e6 if leads else None)


def device_kernels(torch, calls, tries: int = 4):
    """The names of what the calls put on the card, kernels, copies and
    memsets alike, in one profiled session (``profiled``; warm calls
    first), and the session's lead of the card's clock. A record with fewer device events than calls is incomplete
    and the session is taken again with twice the padding, up to
    ``tries`` times; a record with as many or more is returned for the
    caller's check, so a call that puts no kernel, two kernels or a fill
    on the card still fails it."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        _, names, lead = profiled(
            torch, lambda: [fn() for fn in calls],
            PROFILE_PAD_CYCLES << attempt)
        if len(names) >= len(calls):
            break
        log(f"profiler session {attempt + 1}: {len(names)} device events "
            f"for {len(calls)} calls, an incomplete record (the card's "
            f"lead over the host clock {fmt_ms(lead)}); taken again")
    return names, lead


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_flash_decode(torch, ops, timer, cfg):
    """flash_decode at the generate path's shapes (B=4, T=1,024, hd 128,
    8 KV heads) with 64 and 16 query heads, at pos 0, 511 and 1,023, the
    position an int (as the generate path passes it) and a 0-d int32
    tensor on the card. Each call of either form must put exactly one
    kernel on the card: no merge launch, and no fill or copy for the
    position (one profiler session over a call of each form at each
    position). Then the dry-run's decode cell's shape
    (``flash_decode_32k_row``)."""
    import torch.nn.functional as F
    K, hd, B, T = cfg.num_kv_heads, cfg.head_dim, 4, 1024
    rows = []
    for H in (cfg.num_heads, 16):
        g = torch.Generator(device="cuda").manual_seed(14 + H)
        q = torch.randn((B, 1, H, hd), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, T, K, hd), generator=g,
                            device="cuda").bfloat16() for _ in "kv")
        for pos in (0, 511, 1023):
            want = ops.flash_decode(q, k, v, pos, backend="ref")
            n = pos + 1
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (x[:, :n].transpose(1, 2).contiguous() for x in (k, v))
            lib = timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True))
            nbytes = 2 * (2 * B * n * K * hd + 2 * B * H * hd) + 4
            flops = 4 * B * H * hd * n
            b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
            pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            for form, p in (("int", pos), ("tensor", pos_t)):
                label = f"H={H} pos={pos} ({form})"
                got = ops.flash_decode(q, k, v, p)
                torch.cuda.synchronize()
                err, share = attn_err(got, want)
                check(share <= 1, f"flash_decode {label}: max_abs_err "
                                  f"{err}, {share:.3g} of the limit")
                check(torch.equal(got, ops.flash_decode(q, k, v, p)),
                      f"flash_decode {label}: not deterministic")
                ms = timer.ms(lambda: ops.flash_decode(q, k, v, p))
                plain = timer.ms(lambda: ops.flash_decode(q, k, v, p,
                                                          backend="ref"))
                rows.append({"shape": f"q ({B},1,{H},{hd}), k/v ({B},{T},"
                                      f"{K},{hd}) bf16, pos {pos} ({form})",
                             "max_abs_err": err, "share_of_limit": share,
                             "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": lib})
                log(f"flash_decode {label}: max_abs_err {err:.3g} "
                    f"({share:.3g} of the limit) | kernel {ms:.4f} ms | "
                    f"plain {plain:.4f} ms | sdpa {lib:.4f} ms | bound "
                    f"{b_ms:.4f} ms ({b_by})")
        calls = [lambda p=p: ops.flash_decode(q, k, v, p)
                 for pos in (0, 511, 1023)
                 for p in (pos, torch.tensor(pos, dtype=torch.int32,
                                             device="cuda"))]
        one_kernel_each(torch, calls, "flash_decode")
    rows.append(flash_decode_32k_row(torch, ops, timer, cfg))
    return rows


#: the dry-run's decode cell: decode_32k at B = 8, pos 32,767
DECODE_32K = (8, 32768)


def flash_decode_32k_row(torch, ops, timer, cfg):
    """flash_decode at the dry-run decode cell's shape: q (8,1,16,128),
    k/v (8,32768,8,128), pos 32,767 (an int, as ``decode_step`` passes
    it)."""
    import torch.nn.functional as F
    (B, T), H, hd = DECODE_32K, 16, cfg.head_dim
    K, pos = cfg.num_kv_heads, DECODE_32K[1] - 1
    g = torch.Generator(device="cuda").manual_seed(33)
    q = torch.randn((B, 1, H, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, T, K, hd), generator=g, device="cuda")
            .bfloat16() for _ in "kv")
    got = ops.flash_decode(q, k, v, pos)
    want = ops.flash_decode(q, k, v, pos, backend="ref")
    torch.cuda.synchronize()
    err, share = attn_err(got, want)
    label = f"q ({B},1,{H},{hd}), k/v ({B},{T},{K},{hd})"
    check(share <= 1, f"flash_decode {label}: max_abs_err {err}, "
                      f"{share:.3g} of the limit")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True))
    del qt, kt, vt
    ms = timer.ms(lambda: ops.flash_decode(q, k, v, pos))
    plain = timer.ms(lambda: ops.flash_decode(q, k, v, pos, backend="ref"))
    nbytes = 2 * (2 * B * T * K * hd + 2 * B * H * hd)
    b_ms, b_by = bound(nbytes, 4 * B * H * hd * T, BF16_FLOP_PER_S)
    log(f"flash_decode {label} pos {pos}: max_abs_err {err:.3g} "
        f"({share:.3g} of the limit) | kernel {ms:.4f} ms | plain "
        f"{plain:.4f} ms | sdpa {lib:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
    return {"shape": f"{label} bf16, pos {pos} (int; decode_32k, B={B})",
            "max_abs_err": err, "share_of_limit": share, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib}


def ssm_scan_work(B, S, H, hd, N, Q, in_bytes):
    """(bytes, flops, tensor-core flops) of one scan: x, B, C and log_a
    read once, y and the state written once; per (batch, head, chunk) the
    causal half of (M * C B^T) x (row t sums over the t + 1 columns
    s <= t: Q(Q+1)/2 products per column of x), C H^T (every chunk but the
    first, where H is zero) and the state update in full; the causal half
    of C B^T once per (batch, chunk). The tensor-core count, a diagnostic
    that no bound uses, is what the kernel issues for that work: a
    product with one fp32 operand taken as a bf16 pair twice, and with
    fp32 inputs (x, B and C pairs too) every product three times."""
    nc = S // Q
    intra = B * H * nc * Q * (Q + 1) * hd
    inter = B * H * (nc - 1) * 2 * Q * hd * N
    upd = B * H * nc * 2 * Q * hd * N
    cbt = B * nc * Q * (Q + 1) * N
    flops = intra + inter + upd + cbt
    pair = 2 if in_bytes == 2 else 3
    tc = (intra + inter + upd) * pair + cbt * (1 if in_bytes == 2 else 3)
    nbytes = (in_bytes * (B * S * H * hd + 2 * B * S * N) + 4 * B * S * H
              + 4 * B * S * H * hd + 4 * B * H * hd * N)
    return nbytes, flops, tc


#: the ssm_scan phase's (B, S, input dtype) at the hybrid's widths
SSM_SHAPES = ((1, 512, "bfloat16"), (1, 100, "bfloat16"),
              (2, 100, "bfloat16"), (2, 512, "bfloat16"),
              (4, 384, "bfloat16"), (1, 512, "float32"))


def ssm_inputs(torch, B, S, H, hd, N, dt):
    """x (B,S,H,hd), B and C (B,S,N) standard normal in ``dt``, and log_a
    (B,S,H) fp32 at the model's decays (dt * A with dt <~ 0.1, A in
    [-8, -1]), on the card."""
    g = torch.Generator(device="cuda").manual_seed(15 + B * S)
    x = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dt)
    bv, cv = (torch.randn((B, S, N), generator=g, device="cuda").to(dt)
              for _ in "bc")
    la = -0.1 * torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    return x, bv, cv, la


def phase_ssm_scan(torch, ops, timer, cfg):
    """ssm_scan at the hybrid's widths (256 heads of 64, d_state 128,
    chunk 128) over S=512 (four chunks, the main row), one short prompt
    (S=100, one chunk), B 1 and 2, the generate path's prefill (B=4,
    S=384), bf16 inputs as the model gives them, and one case with fp32
    inputs; one call of each shape puts one kernel on the card (one
    profiler session). The bound counts the products the function needs
    at the bf16 tensor-core rate, on which the kernel runs them;
    ``bound_fp32_ms`` counts them at the fp32 CUDA-core rate, and
    ``tc_flops`` is what the kernel issues (``ssm_scan_work``), logged
    only."""
    from repro_torch.models.params import mamba_dims
    _, H, _, _ = mamba_dims(cfg)
    hd, N, chunk = cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.chunk
    rows, calls = [], []
    for B, S, dtype in SSM_SHAPES:
        dt = getattr(torch, dtype)
        x, bv, cv, la = ssm_inputs(torch, B, S, H, hd, N, dt)
        y, st = ops.ssm_scan(x, bv, cv, la, chunk=chunk)
        wy, wst = ops.ssm_scan(x, bv, cv, la, chunk=chunk, backend="ref")
        torch.cuda.synchronize()
        err, share = 0.0, 0.0
        for name, got, want in (("y", y, wy), ("state", st, wst)):
            e = float((got - want).abs().max())
            lim = SSM_REL_TOL * float(want.abs().max())
            check(e <= lim, f"ssm_scan B={B} S={S} {dt}: {name} max_abs_err "
                            f"{e} over the limit {lim}")
            err, share = max(err, e), max(share, e / lim)
        y2, st2 = ops.ssm_scan(x, bv, cv, la, chunk=chunk)
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"ssm_scan B={B} S={S}: not deterministic")
        ms = timer.ms(lambda: ops.ssm_scan(x, bv, cv, la, chunk=chunk))
        plain = timer.ms(lambda: ops.ssm_scan(x, bv, cv, la, chunk=chunk,
                                              backend="ref"), reps=5)
        nbytes, flops, tc = ssm_scan_work(B, S, H, hd, N, min(chunk, S),
                                          x.element_size())
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        b32_ms = bound(nbytes, flops, FP32_FLOP_PER_S)[0]
        kind = "bf16" if dt == torch.bfloat16 else "fp32"
        rows.append({"shape": f"xdt ({B},{S},{H},{hd}) {kind}, N {N}, "
                              f"Q {min(chunk, S)}",
                     "max_abs_err": err, "share_of_limit": share, "ms": ms,
                     "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                     "bound_fp32_ms": b32_ms, "tc_flops": tc,
                     "library_ms": None})
        log(f"ssm_scan B={B} S={S} {kind}: max_abs_err {err:.3g} "
            f"({share:.3g} of the limit) | kernel {ms:.4f} ms | plain "
            f"{plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}; fp32 rate "
            f"{b32_ms:.4f}) | flops {flops:.4g}, issued {tc:.4g}")
        calls.append(lambda x=x, bv=bv, cv=cv, la=la: ops.ssm_scan(
            x, bv, cv, la, chunk=chunk))
    one_kernel_each(torch, calls, "ssm_scan")
    return rows


def bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8)))


def qdma_row(name, shape, ms, plain, nbytes, ops, library=None):
    b_ms, b_by = bound(nbytes, ops, FP32_FLOP_PER_S)
    lib = "" if library is None else f" | library {library:.4f} ms"
    log(f"{name} {shape}: bit-exact | kernel {ms:.4f} ms | plain "
        f"{plain:.4f} ms{lib} | bound {b_ms:.4f} ms ({b_by})")
    return {"shape": shape, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library}


def qdma_leaves(torch, cfg) -> dict:
    """The staging kernels' timed leaves of qwen3-0.6b, from a seed: the
    stacked fp32 MLP weight and a bf16 K pool of the serve engine."""
    g = torch.Generator(device="cuda").manual_seed(21)
    L, E, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    return {
        f"fp32 MLP ({L},{E},{F})": torch.randn((L, E, F), generator=g,
                                               device="cuda") * 0.02,
        f"bf16 K pool ({L},513,16,{cfg.num_kv_heads},{cfg.head_dim})":
            torch.randn((L, 513, 16, cfg.num_kv_heads, cfg.head_dim),
                        generator=g, device="cuda").bfloat16(),
    }


def qdma_descriptors(x) -> tuple:
    """The staging engine's own row chunks of leaf x (32 MiB each): the
    sixth descriptor of a pipelined save (of x's fp32 bytes) and the
    second of a restore (of its int8 bytes), both at a nonzero row."""
    from repro_torch.core.staging import StagingEngine
    R = x.numel() // x.shape[-1]
    eng = StagingEngine()
    return (eng._row_chunks(x.numel() * x.element_size(), R)[5],
            eng._row_chunks(x.numel(), R)[1])


def qdma_special(block: int) -> np.ndarray:
    """(2, 3 * block) fp32: blocks holding a NaN, a +inf, a -inf, a NaN
    and an inf, all zeros (the 1e-12 scale floor), and ordinary values."""
    x = np.random.default_rng(block).standard_normal((6, block))
    x[0, 3] = np.nan
    x[1, 5] = np.inf
    x[2, block - 1] = -np.inf
    x[3, 0], x[3, 7] = np.nan, np.inf
    x[4] = 0
    return x.astype(np.float32).reshape(2, 3 * block)


def qdma_ties(block: int, groups: int = 512) -> np.ndarray:
    """(groups, block) fp32 whose quotients x / scale lie at n + 0.5 and
    a few ulp either side (exact ties among them) and at the +-127 edges:
    each group's max M, at column 0, fixes its scale max(M / 127, 1e-12),
    with M from 2**-140 (subnormal, under the floor) to 2**120."""
    rng = np.random.default_rng(block)
    M = np.exp2(rng.uniform(-40, 120, (groups, 1))).astype(np.float32)
    M[:4] = np.float32(2.0 ** -140)
    s = np.maximum(M * (np.float32(1) / np.float32(127)), np.float32(1e-12))
    n = rng.integers(-127, 127, (groups, block - 5)).astype(np.float32)
    ulp = rng.integers(-3, 4, n.shape).astype(np.int32)
    half = (((n + np.float32(0.5)) * s).view(np.int32) + ulp).view(np.float32)
    edges = s * np.array([127, -127, 126.5, -126.5], np.float32)
    return np.clip(np.concatenate([M, edges, half], axis=1), -M, M)


def phase_qdma_pack(torch, ops, timer, cfg):
    """qdma_pack and qdma_unpack on a fp32 MLP leaf and a bf16 K pool at
    the int8 pause's block 128, the pack of the MLP leaf also at the
    staging engine's default block 256, qdma_pack_rows on one save
    descriptor of the MLP leaf (at both blocks), qdma_unpack on one
    restore descriptor into its rows of the leaf; each output against the
    plain version bit for bit, and each unpack against torch.mul, which
    is timed beside it. First the same checks on small leaves with NaN,
    inf and zero blocks (qdma_special) and with quotients at ties and at
    +-127 (qdma_ties)."""
    from repro_torch.kernels.ref import row_view
    B = QDMA_BLOCK
    for dtype in (torch.float32, torch.bfloat16):
        for block, x in ((b, torch.from_numpy(f(b)).to("cuda").to(dtype))
                         for b in (B, 256) for f in (qdma_special,
                                                     qdma_ties)):
            q, s = ops.qdma_pack(x, block=block)
            wq, ws = ops.qdma_pack(x, block=block, backend="ref")
            rq, rs = ops.qdma_pack_rows(x, 1, rows=len(x) - 1, block=block)
            ok = (bits_equal(torch, q, wq) and bits_equal(torch, s, ws)
                  and bits_equal(torch, rq, wq[1:])
                  and bits_equal(torch, rs, ws[1:]))
            for out in (torch.float32, torch.bfloat16):
                ok = ok and bits_equal(
                    torch, ops.qdma_unpack(q, s, dtype=out),
                    ops.qdma_unpack(q, s, dtype=out, backend="ref"))
            torch.cuda.synchronize()
            check(ok, f"qdma NaN/inf/zero or tie blocks {dtype} block "
                      f"{block}: the kernels differ from the plain versions")
    log("qdma_pack / qdma_pack_rows / qdma_unpack: NaN, inf and zero blocks, "
        "quotients at and beside n + 0.5 and at +-127 (fp32 and bf16, blocks "
        "128 and 256) bit-exact")
    leaves = qdma_leaves(torch, cfg)
    out = {"qdma_pack": [], "qdma_unpack": [], "qdma_pack_rows": []}
    for shape, x in leaves.items():
        for block in (B, 256) if x.shape[-1] % 256 == 0 else (B,):
            q, s = ops.qdma_pack(x, block=block)
            wq, ws = ops.qdma_pack(x, block=block, backend="ref")
            torch.cuda.synchronize()
            check(bits_equal(torch, q, wq) and bits_equal(torch, s, ws),
                  f"qdma_pack {shape} block {block}: differs from the plain "
                  "version")
            n = x.numel()
            io = n * x.element_size() + n + s.numel() * 4
            out["qdma_pack"].append(qdma_row(
                "qdma_pack", f"{shape}, block {block}",
                timer.ms(lambda: ops.qdma_pack(x, block=block)),
                timer.ms(lambda: ops.qdma_pack(x, block=block, backend="ref"),
                         reps=5), io, PACK_OPS * n))
        q, s = ops.qdma_pack(x, block=B)
        u = ops.qdma_unpack(q, s, dtype=x.dtype)
        wu = ops.qdma_unpack(q, s, dtype=x.dtype, backend="ref")
        torch.cuda.synchronize()
        check(bits_equal(torch, u, wu),
              f"qdma_unpack {shape}: differs from the plain version")
        # one library call computes the unpack: int8 promotes to fp32
        # exactly, one IEEE multiply per element, then the cast to out's
        # dtype (round to nearest even), so it gives the kernel's bits
        qb, sb = q.view(*s.shape, B), s.unsqueeze(-1)
        lib_out = torch.empty(qb.shape, dtype=x.dtype, device="cuda")
        torch.mul(qb, sb, out=lib_out)
        check(bits_equal(torch, lib_out.view(x.shape), u),
              f"qdma_unpack {shape}: differs from torch.mul")
        lib = timer.ms(lambda: torch.mul(qb, sb, out=lib_out))
        n = x.numel()
        out["qdma_unpack"].append(qdma_row(
            "qdma_unpack", shape,
            timer.ms(lambda: ops.qdma_unpack(q, s, dtype=x.dtype)),
            timer.ms(lambda: ops.qdma_unpack(q, s, dtype=x.dtype,
                                             backend="ref"), reps=5),
            n * x.element_size() + n + s.numel() * 4, UNPACK_OPS * n,
            library=lib))
        del q, s, wq, ws, u, wu, qb, sb, lib_out
    x = next(iter(leaves.values()))
    R, F = x.numel() // x.shape[-1], x.shape[-1]
    (lo, hi), (rlo, rhi) = qdma_descriptors(x)
    for block in (B, 256):
        q, s = ops.qdma_pack_rows(x, lo, rows=hi - lo, block=block)
        wq, ws = ops.qdma_pack_rows(x, lo, rows=hi - lo, block=block,
                                    backend="ref")
        torch.cuda.synchronize()
        check(lo > 0 and bits_equal(torch, q, wq) and bits_equal(torch, s, ws),
              f"qdma_pack_rows [{lo}, {hi}) block {block}: differs from the "
              "plain version")
        n = (hi - lo) * F
        out["qdma_pack_rows"].append(qdma_row(
            "qdma_pack_rows", f"rows [{lo},{hi}) of the fp32 MLP leaf's "
                              f"({R},{F}) view, block {block}",
            timer.ms(lambda: ops.qdma_pack_rows(x, lo, rows=hi - lo,
                                                block=block)),
            timer.ms(lambda: ops.qdma_pack_rows(x, lo, rows=hi - lo,
                                                block=block, backend="ref"),
                     reps=5),
            n * 4 + n + s.numel() * 4, PACK_OPS * n))
    # one restore descriptor: the unpack of its rows into the leaf
    q, s = (row_view(t)[rlo:rhi] for t in ops.qdma_pack(x, block=B))
    dst = row_view(torch.empty_like(x))[rlo:rhi]
    want = ops.qdma_unpack(q, s, backend="ref")
    ops.qdma_unpack(q, s, out=dst)
    qb, sb = q.view(*s.shape, B), s.unsqueeze(-1)
    lib_out = torch.empty_like(dst)
    torch.mul(qb, sb, out=lib_out.view(qb.shape))
    torch.cuda.synchronize()
    check(rlo > 0 and bits_equal(torch, dst, want),
          f"qdma_unpack restore rows [{rlo}, {rhi}): differs from the plain "
          "version")
    check(bits_equal(torch, lib_out, dst),
          f"qdma_unpack restore rows [{rlo}, {rhi}): differs from torch.mul")
    n = q.numel()
    out["qdma_unpack"].append(qdma_row(
        "qdma_unpack", f"restore rows [{rlo},{rhi}) of the fp32 MLP leaf's "
                       f"({R},{F}) view -> fp32",
        timer.ms(lambda: ops.qdma_unpack(q, s, out=dst)),
        timer.ms(lambda: ops.qdma_unpack(q, s, backend="ref"), reps=5),
        n + s.numel() * 4 + n * 4, UNPACK_OPS * n,
        library=timer.ms(lambda: torch.mul(qb, sb,
                                           out=lib_out.view(qb.shape)))))
    return out


def phase_qdma_digest(torch, ops, timer, cfg):
    """qdma_digest of the fp32 embedding, of byte lengths that are not
    multiples of 16 (or of the JAX kernel's 64 KiB tile), of a view at an
    odd offset, and of bool and int32 leaves; each (2,) result against
    the plain version word for word."""
    g = torch.Generator(device="cuda").manual_seed(22)
    emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                      device="cuda")
    u8 = emb.view(-1).view(torch.uint8)
    cases = {
        f"fp32 embedding ({cfg.vocab_size},{cfg.d_model})": emb,
        f"{u8.numel() - 13} bytes (ragged tail)": u8[:-13],
        f"{u8.numel() - 3} bytes at offset 3": u8[3:],
        "bool (1048583,)": torch.rand(1 << 20 | 7, generator=g,
                                      device="cuda") < 0.5,
        "int32 (513,1001)": torch.randint(-2**31, 2**31 - 1, (513, 1001),
                                          generator=g, device="cuda",
                                          dtype=torch.int32),
    }
    rows = []
    for shape, x in cases.items():
        got, want = ops.qdma_digest(x), ops.qdma_digest(x, backend="ref")
        check(torch.equal(got, want), f"qdma_digest {shape}: "
                                      f"{got.tolist()} != {want.tolist()}")
        check(torch.equal(got, ops.qdma_digest(x)),
              f"qdma_digest {shape}: not deterministic")
        if rows:
            log(f"qdma_digest {shape}: {got.tolist()} == plain")
            continue
        nb = x.numel() * x.element_size()
        rows.append(qdma_row(
            "qdma_digest", shape, timer.ms(lambda: ops.qdma_digest(x)),
            timer.ms(lambda: ops.qdma_digest(x, backend="ref"), reps=3),
            nb + 8, DIGEST_OPS_PER_BYTE * nb))
    return rows


# ---------------------------------------------------------------------------
# serve at full width
# ---------------------------------------------------------------------------
def make_requests(Request, vocab: int, seed: int, first_rid: int = 0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 601, 16)
    lens[:2] = (200, 384)
    reqs = []
    for i, n in enumerate(lens):
        reqs.append(Request(
            rid=first_rid + i,
            prompt=rng.integers(0, vocab, int(n)).astype(np.int32),
            max_new_tokens=32, temperature=0.8 if i % 2 else 0.0,
            top_k=50 if i % 4 == 1 else 0, seed=seed + i))
    return reqs


def hybrid_requests(Request, vocab: int, seed: int):
    """The serve traffic of ``make_requests`` with prompt lengths the SSM
    chunk rule admits (at most 128 tokens, or a multiple of 128): a
    seeded draw in 5-128, three of them set to 256, 384 and 512."""
    reqs = make_requests(Request, vocab, seed)
    rng = np.random.default_rng(seed + 50)
    lens = rng.integers(5, 129, len(reqs))
    lens[:3] = (256, 384, 512)
    for r, n in zip(reqs, lens):
        r.prompt = rng.integers(0, vocab, int(n)).astype(np.int32)
    return reqs


def serve(torch, ops, run, params, kv_dtype, seed, *, fused=True,
          pause_at=None, count=False, requests=make_requests, paged=True,
          host_params=True, engine=None, hook=None):
    """Serve the 16 requests (or those ``requests`` makes) to completion
    (paged, page 16, or through the dense ring); returns (token streams,
    metrics, launch counts). A step that ran no prefill is a decode step
    of the median; ``decode_steps`` counts the steps that decoded. With
    ``pause_at`` the engine is paused after that step, its device state
    (the params too, unless ``host_params`` is False) staged to host
    memory and dropped, restored and unpaused. ``engine()``, when given,
    builds the engine in place of the single-stage one; ``hook(eng,
    steps)`` runs before each step."""
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.tree import tree_to
    eng = (engine() if engine is not None else
           ServeEngine(run, params, device="cuda", slots=8, max_len=1024,
                       paged=paged, page_size=16, kv_dtype=kv_dtype,
                       fused_sampling=fused))
    reqs = requests(Request, run.model.vocab_size, seed)
    for r in reqs:
        eng.submit(r)
    if count:
        ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_ms, steps, decoded = [], 0, 0
    while steps < 2000:
        if hook is not None:
            hook(eng, steps)
        before = eng.prefill_calls
        ts = time.perf_counter()
        n = eng.step()
        torch.cuda.synchronize()
        if n and eng.prefill_calls == before:
            decode_ms.append((time.perf_counter() - ts) * 1e3)
        decoded += bool(n)
        steps += 1
        if n == 0 and not eng.queue:
            break
        if steps == pause_at:
            eng.pause()
            st = eng.export_state()
            host = dict(st, cache=tree_to(st["cache"], "cpu"))
            if host_params:
                host["params"] = tree_to(st["params"], "cpu")
            eng._cache = None
            torch.cuda.empty_cache()
            eng.import_state(host)
            eng.unpause()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts() if count else None
    check(all(r.done and r.error is None for r in reqs),
          f"serve kv={kv_dtype}: not every request completed")
    check(all(len(r.out) == r.max_new_tokens for r in reqs),
          f"serve kv={kv_dtype}: a request stopped short")
    toks = sum(len(r.out) for r in reqs)
    metrics = {"steps": steps, "wall_s": wall, "tokens": toks,
               "tokens_per_s": toks / wall,
               "decode_step_ms_median": float(np.median(decode_ms)),
               "decode_steps_timed": len(decode_ms), "decode_steps": decoded}
    del eng
    torch.cuda.empty_cache()
    return [list(r.out) for r in reqs], metrics, counts


# ---------------------------------------------------------------------------
# SVFF: engines as tenants of the manager, reconfigured under traffic
# ---------------------------------------------------------------------------
class StagingLog:
    """Wraps a StagingEngine's save and restore to keep each call's
    TransferStats (and, with ``keep``, the tree the last save was handed:
    the state a pause exported)."""

    def __init__(self, engine, keep: bool = False):
        self.saves, self.restores, self.last_tree = [], [], None
        save, restore = engine.save, engine.restore

        def logged_save(tree, *a, **k):
            out = save(tree, *a, **k)
            self.saves.append(engine.last_stats)
            if keep:
                self.last_tree = tree
            return out

        def logged_restore(*a, **k):
            out = restore(*a, **k)
            self.restores.append(engine.last_stats)
            return out
        engine.save, engine.restore = logged_save, logged_restore


def transfer_row(stats) -> dict:
    moved = sum(s.bytes_moved for s in stats)
    secs = sum(s.seconds for s in stats)
    return {"calls": len(stats), "bytes_moved": moved,
            "logical_bytes": sum(s.logical_bytes for s in stats),
            "skipped_bytes": sum(s.skipped_bytes for s in stats),
            "seconds": secs, "gb_per_s": moved / max(secs, 1e-9) / 1e9}


def fleet_requests(Request, vocab: int, seed: int) -> list:
    """Sixteen requests per engine of a two-engine fleet: two draws."""
    return (make_requests(Request, vocab, seed)
            + make_requests(Request, vocab, seed + 1, first_rid=16))


def make_fleet(run, params, device, workdir, kv_dtype=None):
    """Two engine tenants of qwen3-0.6b (8 slots, max_len 1024, page 16,
    bf16 KV unless ``kv_dtype``, fused sampling) over a pool of four
    logical slots."""
    from repro_torch.serve.fleet import ServeFleet
    return ServeFleet(run, params, num_engines=2, num_devices=4, slots=8,
                      max_len=1024, page_size=16, fused_sampling=True,
                      kv_dtype=kv_dtype, device=device, workdir=workdir)


def drive_fleet(fleet, reqs, schedule: dict, label: str,
                arrive_every: int = 0) -> list:
    """Submit the requests — all at once, or request i before fleet step
    ``i * arrive_every`` — and step the fleet, running ``schedule[k]()``
    before fleet step k (after that step's arrivals); drain, and check
    that every request completed. Returns the token streams."""
    if not arrive_every:
        for r in reqs:
            fleet.submit(r)
    last = max(max(schedule, default=-1), (len(reqs) - 1) * arrive_every)
    for k in range(last + 1):
        if arrive_every and k % arrive_every == 0 and \
                k // arrive_every < len(reqs):
            fleet.submit(reqs[k // arrive_every])
        if k in schedule:
            schedule[k]()
        fleet.step()
    res = fleet.drain()
    check(res.drained and all(r.done and r.error is None for r in reqs),
          f"{label}: not every request completed")
    check(all(len(r.out) == 32 for r in reqs),
          f"{label}: a request stopped short")
    check(not fleet.mgr.journal.pending(), f"{label}: journal entries left "
                                           "pending")
    return [list(r.out) for r in reqs]


def engine_bytes(torch, eng) -> int:
    """Device bytes an engine holds: params, their compute-dtype copy and
    the page pools, each storage counted once."""
    from repro_torch.tree import tree_leaves
    seen = {}
    for t in (tree_leaves(eng.params) + tree_leaves(eng._cparams)
              + tree_leaves(eng._cache)):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def allocated(torch, device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(device)


def release(torch):
    """Return what the dropped objects held to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def phase_svff(torch, run, params, seed, device, workdir):
    """The paper-faithful path (the default staging engine: bit-exact, no
    compression): a reference fleet serves 32 requests undisturbed; a
    second fleet serves the same requests while it runs, mid-traffic, a
    live pause of serve0 (two pre-copy rounds) and its unpause, the
    reconf cycle to 3 VFs through pause, the same through detach/attach
    (state parked on disk), and a migrate of serve1. Every token stream
    must equal the reference's; the pause must free the paused engine's
    device memory and the unpause bring it back. Returns (the report,
    the reference's token streams)."""
    from repro_torch.serve.engine import Request
    vocab = run.model.vocab_size
    fleet = make_fleet(run, params, device, os.path.join(workdir, "ref"))
    ref = drive_fleet(fleet, fleet_requests(Request, vocab, seed), {},
                      "SVFF reference")
    del fleet
    release(torch)
    fleet = make_fleet(run, params, device, os.path.join(workdir, "svff"))
    slog = StagingLog(fleet.mgr.staging)
    res = {}

    def live():
        eng = fleet.tenants["serve0"].engine
        state = engine_bytes(torch, eng)
        m0 = allocated(torch, device)
        t = fleet.pause_live("serve0", rounds=2)
        m1 = allocated(torch, device)
        stop = fleet.mgr.snapshots["serve0"].stats
        fleet.step()                          # serve1 serves on meanwhile
        tu = fleet.unpause("serve0")
        m2 = allocated(torch, device)
        res["pause_live"] = {
            "phases_ms": {k: v * 1e3 for k, v in t.phases.items()},
            "stop_ms": t.stop_ms, "total_ms": t.total * 1e3,
            "unpause_ms": {k: v * 1e3 for k, v in tu.phases.items()},
            "stop_and_copy": transfer_row([stop]),
            "precopy_and_stop": transfer_row(slog.saves[-3:]),
            "restore": transfer_row(slog.restores[-1:]),
            "engine_bytes": state, "freed_bytes": m0 - m1,
            "back_bytes": m2 - m1}
        if device.type == "cuda":
            check(m0 - m1 >= 0.9 * state,
                  f"pause freed {m0 - m1} of the engine's {state} device "
                  "bytes (< 90%)")
            check(m2 - m1 >= 0.9 * state,
                  f"unpause brought back {m2 - m1} of {state} bytes")

    def reconf(use_pause):
        n0, r0 = len(slog.saves), len(slog.restores)
        tim = fleet.mgr.reconf(3, use_pause=use_pause)
        res["reconf_pause" if use_pause else "reconf_detach_attach"] = {
            "table2_ms": {k: v * 1e3 for k, v in tim.items()},
            "saves": transfer_row(slog.saves[n0:]),
            "restores": transfer_row(slog.restores[r0:])}

    def migrate():
        n0 = len(slog.saves)
        info = fleet.migrate("serve1")
        res["migrate"] = {"migrate_ms": info["migrate_s"] * 1e3,
                          "new_devices": info["new_devices"],
                          "saves": transfer_row(slog.saves[n0:])}

    out = drive_fleet(fleet, fleet_requests(Request, vocab, seed),
                      {6: live, 14: lambda: reconf(True),
                       20: lambda: reconf(False), 26: migrate}, "SVFF")
    check(out == ref, "SVFF: a reconfiguration changed the tokens (I10)")
    return res, ref


def int8_bound(torch, exported, eng, engine, label) -> float:
    """The restored state against the state the pause exported: each
    leaf the staging engine packed within its blocks' int8 bound, every
    other leaf equal. Returns the largest share of the bound used."""
    for key in ("pos", "last_token", "tables"):
        check(np.array_equal(exported[key], getattr(eng, key)),
              f"{label}: {key} changed")
    return int8_share(torch, {"params": exported["params"],
                              "cache": exported["cache"]},
                      {"params": eng.params, "cache": eng._cache}, engine,
                      label)


def int8_share(torch, exported, restored, engine, label) -> float:
    """Leaf by leaf, ``restored`` against ``exported``: a leaf the int8
    engine packs within its blocks' bound, any other leaf bit-equal.
    Returns the largest share of the bound used."""
    from repro_torch.kernels.ref import INV127
    from repro_torch.tree import flatten
    want, got = flatten(exported)[0], flatten(restored)[0]
    check([p for p, _ in want] == [p for p, _ in got],
          f"{label}: the restored state has another structure")
    worst = 0.0
    for (path, x), (_, y) in zip(want, got):
        if not engine._pack_eligible(x):
            check(bits_equal(torch, x, y), f"{label} {path}: changed")
            continue
        xb = x.float().reshape(-1, QDMA_BLOCK)
        yb = y.float().reshape(-1, QDMA_BLOCK)
        lim = ((xb.abs().amax(-1, keepdim=True) * INV127).clamp_min(1e-12)
               * (0.5 + INT8_SLACK))
        if x.dtype == torch.bfloat16:
            lim = lim + yb.abs() * BF16_HALF_STEP
        share = float(((xb - yb).abs() / lim).max())
        check(share <= 1, f"{label} {path}: restored value outside the int8 "
                          f"bound ({share:.3g} of it)")
        worst = max(worst, share)
    return worst


def phase_svff_int8(torch, run, params, seed, device, workdir):
    """The compressed path: the same fleet and traffic with the int8
    staging engine (block 128, digest dirty tracking, stream transport)
    for a live pause of serve0 and its unpause, then one pause of serve1
    through the PR-1 engine (``pipeline=False``). Int8 staging is lossy
    by design, so tokens are not compared: every request must complete,
    each restored leaf must lie within its int8 bound of the exported
    one, and each save must move under 40% of the logical bytes."""
    from repro_torch.core.staging import StagingEngine
    from repro_torch.serve.engine import Request
    fleet = make_fleet(run, params, device, os.path.join(workdir, "int8"))
    res = {}

    def pause_cycle(tid, engine, live):
        fleet.mgr.staging = engine
        slog = StagingLog(engine, keep=True)
        tn = fleet.tenants[tid]
        t = (fleet.pause_live(tid, rounds=2) if live
             else fleet.mgr.pause(tn))
        exported, slog.last_tree = slog.last_tree, None
        fleet.step()
        tu = fleet.unpause(tid)
        share = int8_bound(torch, exported, tn.engine, engine, tid)
        for s in slog.saves:
            check(s.bytes_moved < 0.4 * s.logical_bytes,
                  f"{tid}: an int8 save moved {s.bytes_moved} of "
                  f"{s.logical_bytes} logical bytes (>= 40%)")
        res["pause_live" if live else "pause_pipeline_false"] = {
            "stop_ms": t.stop_ms, "total_ms": t.total * 1e3,
            "unpause_ms": tu.total * 1e3,
            "saves": [transfer_row([s]) for s in slog.saves],
            "restores": transfer_row(slog.restores),
            "int8_bound_share": share}

    drive_fleet(fleet, fleet_requests(Request, run.model.vocab_size, seed),
                {6: lambda: pause_cycle("serve0", StagingEngine(
                    compression="int8", block=QDMA_BLOCK, incremental=True,
                    dirty="digest", transport="stream"), True),
                 12: lambda: pause_cycle("serve1", StagingEngine(
                     compression="int8", block=QDMA_BLOCK, pipeline=False),
                     False)}, "SVFF int8")
    return res


def log_svff(report, card):
    """The SVFF phases' numbers, each line with the card's name and power
    limit."""
    sv, s8 = report["svff"], report["svff_int8"]
    for key, what in (("reconf_pause", "pause/unpause"),
                      ("reconf_detach_attach", "detach/attach")):
        t = sv[key]["table2_ms"]
        log(f"SVFF reconf to 3 VFs via {what}: " + ", ".join(
            f"{k} {t[k]:.2f}" for k in ("rescan", "remove_vf",
                                        "change_num_vf", "add_vf", "total"))
            + f" ms | saves {sv[key]['saves']['bytes_moved']:,} B at "
            f"{sv[key]['saves']['gb_per_s']:.2f} GB/s | {card}")
    p = sv["pause_live"]
    log(f"SVFF live pause (2 pre-copy rounds): stop {p['stop_ms']:.2f} ms of "
        f"{p['total_ms']:.2f} ms total | stop-and-copy "
        f"{p['stop_and_copy']['bytes_moved']:,} B at "
        f"{p['stop_and_copy']['gb_per_s']:.2f} GB/s | restore "
        f"{p['restore']['bytes_moved']:,} B at "
        f"{p['restore']['gb_per_s']:.2f} GB/s | freed "
        f"{p['freed_bytes']:,} of the engine's {p['engine_bytes']:,} device "
        f"bytes, {p['back_bytes']:,} back | {card}")
    log(f"SVFF migrate serve1: {sv['migrate']['migrate_ms']:.2f} ms | tokens "
        f"equal the undisturbed fleet's | {card}")
    for key in ("pause_live", "pause_pipeline_false"):
        p = s8[key]
        moved = [s["bytes_moved"] / max(s["logical_bytes"], 1)
                 for s in p["saves"]]
        log(f"SVFF int8 {key}: stop {p['stop_ms']:.2f} ms of "
            f"{p['total_ms']:.2f} ms | unpause {p['unpause_ms']:.2f} ms | "
            f"saves moved "
            + ", ".join(f"{m:.3f}" for m in moved)
            + f" of logical | restore {p['restores']['gb_per_s']:.2f} GB/s |"
            f" int8 bound share {p['int8_bound_share']:.3g} | {card}")


def phase_prefill_logits(torch, run, params, seed):
    """Prefill logits through the kernels vs through the plain versions
    (``kernel_backend="reference"``) on the same weights and prompts."""
    from repro_torch.models.model import build_model
    fast, plain = build_model(run), build_model(
        run.replace(kernel_backend="reference"))
    rng = np.random.default_rng(seed + 100)
    worst = 0.0
    for S in (200, 384):
        toks = torch.tensor(rng.integers(0, run.model.vocab_size, (1, S)),
                            device="cuda")
        _, a = fast.prefill(params, {"tokens": toks})
        _, b = plain.prefill(params, {"tokens": toks})
        rel = float((a - b).abs().max() / b.abs().max())
        check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
              f"prefill S={S}: non-finite or misshapen logits")
        check(rel <= LOGITS_REL_TOL,
              f"prefill S={S}: kernel vs plain logits differ by {rel:.3g} "
              f"of max |logit|")
        worst = max(worst, rel)
    log(f"prefill logits, kernel vs plain path (S=200, 384): max rel err "
        f"{worst:.3g} (tolerance {LOGITS_REL_TOL})")
    return worst


# ---------------------------------------------------------------------------
# the hybrid Mamba-attention stack
# ---------------------------------------------------------------------------
def phase_generate(torch, ops, run, params, seed):
    """``make_serve_steps``' generate path: prefill B=4 prompts of 384
    tokens (timed), widen the cache to a dense one of 1,024 positions,
    then 128 decode steps with one position for the batch (384 ... 511),
    each step's logits against one teacher-forced forward at S=512. Any
    stack: the kernels it must launch are those of its blocks
    (flash_attention and flash_decode for attention, ssm_scan for mamba;
    an xLSTM stack launches none). The launch counts cover the prefill
    and the decode steps only."""
    import dataclasses
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_serve_steps
    from repro_torch.tree import tree_map
    B, S0, S, T = 4, 384, 512, 1024
    model = build_model(run)
    cparams = model.compute_params(params)
    prefill, decode = make_serve_steps(run)
    rng = np.random.default_rng(seed + 300)
    toks = torch.tensor(rng.integers(0, run.model.vocab_size, (B, S)),
                        device="cuda")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    ts = time.perf_counter()
    cache, last = prefill(cparams, {"tokens": toks[:, :S0]})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - ts) * 1e3
    dense = model.init_cache(dataclasses.replace(run.shape, seq_len=T,
                                                 global_batch=B),
                             device="cuda")
    for blk, node in cache.items():
        for name, leaf in node.items():
            if name in ("k", "v"):
                dense[blk][name][:, :, :S0] = leaf
            else:           # recurrent state (nested for the xLSTM's)
                tree_map(lambda d, t: d.copy_(t), dense[blk][name], leaf)
    del cache
    logits, step_ms = [last], []
    for t in range(S0, S - 1):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        lg, dense = decode(cparams, dense, toks[:, t:t + 1], t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        logits.append(lg)
    # the last step, profiled: the kernels one step puts on the card, by
    # name. A record that holds fewer flash_decode kernels than the step
    # launched is taken again with twice the padding, up to four
    # sessions, each from the cache as it was before the step (the step
    # advances the recurrent state)
    before_step = tree_map(lambda t: t.clone(), dense)
    for attempt in range(4):
        if attempt:
            tree_map(lambda t, t0: t.copy_(t0), dense, before_step)
        before = ops.LAUNCHES["flash_decode"]
        (lg, dense), names, lead = profiled(
            torch, lambda: decode(cparams, dense, toks[:, S - 1:S], S - 1),
            PROFILE_PAD_CYCLES << attempt)
        launched = ops.LAUNCHES["flash_decode"] - before
        n_attn = sum(1 for n in names if "flash_decode" in n)
        if n_attn >= launched:
            break
        log(f"generate: profiler session {attempt + 1} recorded {n_attn} "
            f"flash_decode kernels of {launched} launched ({len(names)} "
            f"device events; the card's lead over the host clock "
            f"{fmt_ms(lead)}), an incomplete record; taken again")
    del before_step
    logits.append(lg)
    counts = ops.launch_counts()
    del dense
    full = model.forward(cparams, {"tokens": toks})[0]
    del cparams
    scale = float(full.abs().max())
    errs = [float((lg - full[:, S0 - 1 + i]).abs().max())
            for i, lg in enumerate(logits)]
    name = run.model.name
    check(all(np.isfinite(errs)), f"{name} generate: non-finite logits")
    check(max(errs) <= GEN_REL_TOL * scale,
          f"{name} generate: decode logits differ from the forward by "
          f"{max(errs) / scale:.3g} of max |logit| (> {GEN_REL_TOL})")
    pattern = run.model.block_pattern
    kernels = [k for k in GENERATE_KERNELS
               if ("mamba" if k == "ssm_scan" else "attn") in pattern]
    for k in kernels:
        check(counts[k] > 0, f"{name}: {k} was never launched on the "
                             "generate path")
    layers = pattern.count("attn") * run.model.num_periods
    check(launched == layers,
          f"{name} generate: the last step launched {launched} flash_decode "
          f"kernels for {layers} attention layers")
    if names:       # the profiler saw the step's device work
        check(n_attn == launched,
              f"{name} generate: in {attempt + 1} profiler sessions the "
              f"record of the last step held {len(names)} device events "
              f"but {n_attn} of its {launched} flash_decode kernels")
    else:
        log(f"{name} generate: the profiler recorded no device work for "
            "the last step")
    res = {"rel_err": max(errs) / scale, "steps": len(step_ms) + 1,
           "prefill_ms": prefill_ms,
           "decode_step_ms_median": float(np.median(step_ms)),
           "launches": counts, "kernels_per_step": len(names),
           "fill_kernels_per_step": sum(1 for n in names
                                        if "fill" in n.lower()),
           "profiler_sessions": attempt + 1, "card_lead_ms": lead,
           "step_kernels": {n: names.count(n) for n in sorted(set(names))}}
    log(f"{name} generate B={B} prefill {S0} ({prefill_ms:.1f} ms) + "
        f"{res['steps']} uniform-pos decode steps (T={T}): max rel err vs "
        f"forward {res['rel_err']:.3g} (tolerance {GEN_REL_TOL}) | decode "
        f"step median {res['decode_step_ms_median']:.2f} ms | a step: "
        f"{res['kernels_per_step']} kernels, "
        f"{res['fill_kernels_per_step']} fills (profiler sessions "
        f"{attempt + 1}, the card's lead over the host clock "
        f"{fmt_ms(lead)}) | launches "
        f"{json.dumps({k: counts[k] for k in kernels})}")
    return res


def phase_profile(torch, run, params, seed, name="decode",
                  requests=make_requests):
    """``--profile``: where a decode step's time goes. Eight requests fill
    the eight slots; after their prefills and two warm steps, eight decode
    steps run under torch.profiler. Reports the wall time per step, the
    device's busy share (the sum of kernel times over the wall time) and
    the kernels by device time; ``main`` writes it to
    ``profile_<name>.json``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(run, params, device="cuda", slots=8, max_len=1024,
                      paged=True, page_size=16, fused_sampling=True)
    for r in requests(Request, run.model.vocab_size, seed)[:8]:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    steps = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' device time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": e.key, "calls": e.count,
                         "device_ms_per_step": dev_us / 1e3 / steps})
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    busy = sum(r["device_ms_per_step"] for r in rows)
    res = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_busy_ms_per_step": busy,
           "device_busy_share": busy / (wall_ms / steps), "kernels": rows}
    log(f"profile {name}: decode step {wall_ms / steps:.2f} ms wall, "
        f"device busy "
        f"{busy:.2f} ms ({100 * busy / (wall_ms / steps):.1f}%)")
    for r in rows[:12]:
        log(f"  {r['device_ms_per_step']:8.3f} ms/step "
            f"{r['calls'] // steps:5d} calls/step  {r['name'][:90]}")
    return res


# ---------------------------------------------------------------------------
# the elastic fleet: request live migration, scale-in, recovery, autoscaler
# ---------------------------------------------------------------------------
STALL_BOUND = 2.0        # frozen-slot ticks per completed migration (the
#                          JAX migration benchmark's bound)
MIGRATE_FROM = 3         # the first migration before this fleet step,
MIGRATE_EVERY = 5        # then one every this many steps
ARRIVE_EVERY = 2         # a request arrives every this many fleet steps
SCALE_IN_AT = 10
RECOVER_AT = 8
ELASTIC_KERNELS = ("flash_attention", "paged_decode", "paged_decode_quant",
                   "fused_sample")


def migration_schedule(torch, fleet, migrations, label, int8=False):
    """``{step: migrate}`` for ``drive_fleet``: from MIGRATE_FROM, every
    MIGRATE_EVERY steps one in-flight request moves from the engine with
    more active slots to the other. Each completed migration's result,
    shipped bytes and GB/s go to ``migrations``; with ``int8`` pools the
    target's pages are checked against the source's right after the
    hand-off, before a decode step writes the next row into them."""
    slog = StagingLog(fleet.mgr.staging)

    def migrate():
        running = sorted(fleet.tenants.values(),
                         key=lambda tn: fleet._order[tn.tid])
        src = max(running, key=lambda tn: (sum(
            r is not None for r in tn.engine.active),
            -fleet._order[tn.tid]))
        dst = next(tn for tn in running if tn.tid != src.tid)
        rid = src.peek_migratable()
        if rid is None:
            return
        if int8:
            pages = src.engine.alloc.pages_of(rid)
            chain = {(blk, n): (node[n][:, pages].cpu(),
                                node[n + "_scale"][:, pages].cpu())
                     for blk, node in src.engine._cache.items()
                     for n in ("k", "v")}
        n0, r0 = len(slog.saves), len(slog.restores)
        res = fleet.migrate_request(src.tid, dst.tid, rid)
        if res is None:
            migrations.append({"rid": rid, "completed": False})
            return
        ms = res["migrate_request_s"] * 1e3
        shipped = transfer_row(slog.saves[n0:])["bytes_moved"]
        migrations.append({
            "rid": rid, "completed": True, "src": src.tid, "dst": dst.tid,
            "ms": ms, "blocks": res["blocks"], "bytes_shipped": shipped,
            "gb_per_s": shipped / (ms * 1e-3) / 1e9,
            "save": transfer_row(slog.saves[n0:]),
            "restore": transfer_row(slog.restores[r0:])})
        if int8:
            check_requantized(torch, dst.engine, rid, chain, label)

    return {MIGRATE_FROM + MIGRATE_EVERY * i: migrate for i in range(12)}


def check_requantized(torch, eng, rid, chain, label):
    """A migrated int8 request's target pages and scales against the
    port's plain requantization of the source's dequantized pages,
    computed on the host: bit for bit."""
    from repro_torch.kernels.ref import kv_dequant_ref, kv_quant_ref
    pages = eng.alloc.pages_of(rid)
    for (blk, n), (q, s) in chain.items():
        want_q, want_s = kv_quant_ref(kv_dequant_ref(q, s))
        node = eng._cache[blk]
        check(torch.equal(node[n][:, pages].cpu(), want_q)
              and bits_equal(torch, node[n + "_scale"][:, pages].cpu(),
                             want_s),
              f"{label}: request {rid}'s {blk}/{n} pages on the target are "
              "not the plain requantization of the source's")


def migration_summary(migrations, fleet) -> dict:
    done = [m for m in migrations if m["completed"]]
    stall = sum(tn.engine.stats["migration_stall_ticks"]
                for tn in fleet.tenants.values())
    return {"attempted": len(migrations), "completed": len(done),
            "stall_ticks": stall,
            "stall_per_migration": stall / max(len(done), 1),
            "ms": [m["ms"] for m in done],
            "blocks": [m["blocks"] for m in done],
            "bytes_shipped": [m["bytes_shipped"] for m in done],
            "gb_per_s": [m["gb_per_s"] for m in done],
            "save_gb_per_s": [m["save"]["gb_per_s"] for m in done],
            "restore_gb_per_s": [m["restore"]["gb_per_s"] for m in done]}


def phase_migration(torch, run, params, seed, device, workdir, ref, card):
    """Request live migration under traffic, bf16 then int8 KV pages (the
    default, bit-exact staging engine ships each chain). bf16: every
    stream equals the undisturbed fleet's (``ref``), stall ticks per
    migration <= STALL_BOUND, >= 4 migrations complete. int8: every
    migrated request's target pages are the plain requantization of the
    source's; how many streams equal an undisturbed int8 fleet's is
    logged, not held (a requantization may move a scale by one ulp)."""
    from repro_torch.serve.engine import Request
    vocab = run.model.vocab_size
    res = {}
    for kv in (None, "int8"):
        name = kv or "bf16"
        label = f"migration kv={name}"
        fleet = make_fleet(run, params, device,
                           os.path.join(workdir, f"mig_{name}"),
                           kv_dtype=kv)
        migrations = []
        out = drive_fleet(fleet, fleet_requests(Request, vocab, seed),
                          migration_schedule(torch, fleet, migrations, label,
                                             int8=kv is not None),
                          label, arrive_every=ARRIVE_EVERY)
        summary = migration_summary(migrations, fleet)
        check(summary["completed"] >= 4,
              f"{label}: {summary['completed']} migrations completed (< 4)")
        check(summary["stall_per_migration"] <= STALL_BOUND,
              f"{label}: {summary['stall_per_migration']:.2f} stall ticks "
              f"per migration (> {STALL_BOUND})")
        if kv is None:
            check(out == ref, f"{label}: a migration changed the tokens "
                              "(I10)")
            summary["streams_equal"] = len(out)
        else:
            del fleet
            release(torch)
            fleet = make_fleet(run, params, device,
                               os.path.join(workdir, "mig_int8_ref"),
                               kv_dtype=kv)
            plain = drive_fleet(fleet, fleet_requests(Request, vocab, seed),
                                {}, "int8 reference",
                                arrive_every=ARRIVE_EVERY)
            summary["streams_equal"] = sum(a == b
                                           for a, b in zip(out, plain))
        res[name] = summary
        del fleet
        release(torch)
        for m in migrations:
            if m["completed"]:
                log(f"{label}: request {m['rid']} {m['src']} -> {m['dst']} "
                    f"{m['ms']:.2f} ms, {m['blocks']} blocks, "
                    f"{m['bytes_shipped']:,} B shipped, "
                    f"{m['gb_per_s']:.2f} GB/s end to end (save "
                    f"{m['save']['gb_per_s']:.2f}, restore "
                    f"{m['restore']['gb_per_s']:.2f} GB/s) | {card}")
        log(f"{label}: {summary['completed']} of {summary['attempted']} "
            f"migrations completed, {summary['stall_ticks']} stall ticks, "
            f"{summary['streams_equal']} of 32 streams equal the "
            f"undisturbed fleet's | {card}")
    return res


def phase_scale_in(torch, run, params, seed, device, workdir, ref, card):
    """``scale_in("serve1")`` at fleet step SCALE_IN_AT while it is busy:
    its queue resubmits to serve0, its in-flight requests live-migrate
    (>= 1 must), every stream equals the undisturbed fleet's, and the
    detach frees >= 90% of serve1's device bytes."""
    from repro_torch.serve.engine import Request
    fleet = make_fleet(run, params, device, os.path.join(workdir, "scalein"))
    res = {}

    def scale_in():
        tn = fleet.tenants["serve1"]
        check(tn.load > 0, "scale-in: serve1 is not busy at the call")
        inflight = sum(r is not None for r in tn.engine.active)
        state = engine_bytes(torch, tn.engine)
        m0 = allocated(torch, device)
        t0 = time.perf_counter()
        fleet.scale_in("serve1")
        ms = (time.perf_counter() - t0) * 1e3
        release(torch)
        m1 = allocated(torch, device)
        desc = fleet.telemetry.describe()["serve1"]
        res.update({"ms": ms, "inflight": inflight,
                    "migrated": desc["migrations_completed"],
                    "engine_bytes": state, "freed_bytes": m0 - m1,
                    "status": tn.status})
        check(desc["migrations_completed"] >= 1,
              "scale-in: no in-flight request migrated")
        check(tn.status == "detached", f"scale-in: serve1 is {tn.status}")
        if device.type == "cuda":
            check(m0 - m1 >= 0.9 * state,
                  f"scale-in freed {m0 - m1} of serve1's {state} device "
                  "bytes (< 90%)")

    out = drive_fleet(fleet, fleet_requests(Request, run.model.vocab_size,
                                            seed),
                      {SCALE_IN_AT: scale_in}, "scale-in",
                      arrive_every=ARRIVE_EVERY)
    check(out == ref, "scale-in: the drain changed the tokens (I10)")
    del fleet
    release(torch)
    log(f"scale-in of busy serve1 at step {SCALE_IN_AT}: {res['ms']:.2f} ms, "
        f"{res['migrated']} of {res['inflight']} in-flight requests "
        f"migrated, freed {res['freed_bytes']:,} of its "
        f"{res['engine_bytes']:,} device bytes | streams equal the "
        f"undisturbed fleet's | {card}")
    return res


def phase_recovery(torch, run, params, seed, device, workdir, ref, card):
    """``recover_engine("serve0")`` at fleet step RECOVER_AT: its live
    requests re-home onto serve1 and regenerate from their prompts; every
    stream equals the undisturbed fleet's, and serve0 serves again (the
    later arrivals land on it and complete)."""
    from repro_torch.serve.engine import Request
    fleet = make_fleet(run, params, device, os.path.join(workdir, "recover"))
    res = {}

    # the engine each request is submitted to after the crash
    after_crash = {}
    submit = fleet.submit

    def crash():
        t0 = time.perf_counter()
        out = fleet.recover_engine("serve0")
        res.update({"ms": (time.perf_counter() - t0) * 1e3,
                    "rehomed": [rid for rid, _ in out["rehomed"]]})
        check(res["rehomed"], "recovery: serve0 held no live request")

    def noted_submit(r):
        tid = submit(r)
        if "ms" in res:
            after_crash[r.rid] = tid
        return tid
    fleet.submit = noted_submit
    reqs = fleet_requests(Request, run.model.vocab_size, seed)
    out = drive_fleet(fleet, reqs, {RECOVER_AT: crash}, "recovery",
                      arrive_every=ARRIVE_EVERY)
    check(out == ref, "recovery: a re-homed request regenerated other "
                      "tokens (I10)")
    after = [rid for rid, tid in after_crash.items() if tid == "serve0"]
    check(after and all(reqs[rid].done for rid in after),
          "recovery: serve0 served nothing after its reset")
    res["served_after"] = len(after)
    del fleet
    release(torch)
    log(f"recovery of serve0 at step {RECOVER_AT}: {res['ms']:.2f} ms, "
        f"{len(res['rehomed'])} requests re-homed and regenerated "
        f"bit-identically, serve0 then served {len(after)} requests | "
        f"{card}")
    return res


ELASTIC_SWEEP_LAYERS = 4  # the sweep's qwen3-0.6b at full width, 4 of
                          # its 28 layers: its gates and actions read loads
                          # only, and at 28 layers it took 71-106 s of the
                          # script's 1,200 on the H100 (PERF.md)


def elastic_cpu_actions() -> dict:
    """The elastic benchmark at the smoke width on the CPU (a host lane
    job): {"actions": its action kinds per trace}."""
    import torch
    from repro_torch.bench.elastic_sweep import bench
    from repro_torch.configs import make_run_config
    from repro_torch.models.model import build_model
    srun = make_run_config("qwen3-0.6b", "decode_32k", smoke=True)
    rows = bench(srun, build_model(srun).init(seed=0, device="cpu"),
                 torch.device("cpu"), log=lambda s: None)
    return {"actions": rows[-1]["actions_per_trace"]}


def phase_elastic_sweep(torch, run, params, device, card, lane=None):
    """The JAX elastic benchmark's protocol (60 ticks, peak 3, max_new 8,
    slots 8, slo_max_load 16, 8 logical devices; the elastic fleet 1
    engine + 3 spares over 4 VFs) at full width cut to
    ELASTIC_SWEEP_LAYERS on the card (weights from the seed), and at the
    smoke width on the CPU (``elastic_cpu_actions``, from the host lane
    ``lane`` where there is one): on spike and ramp elastic beats static
    on rejection and SLO-miss rate, and each trace's action kinds equal
    the CPU run's (the plan reads loads only). TTFT and ITL in ticks and
    ms."""
    import dataclasses
    from repro_torch.bench.elastic_sweep import bench
    from repro_torch.models.model import build_model
    run = run.replace(model=dataclasses.replace(
        run.model, num_layers=ELASTIC_SWEEP_LAYERS))
    params = build_model(run).init(seed=run.seed, device=device)
    t0 = time.perf_counter()
    rows = bench(run, params, device, log=lambda s: None)
    wall = time.perf_counter() - t0
    summary = rows[-1]
    cpu_actions = (elastic_cpu_actions() if lane is None
                   else lane_result(lane, "elastic_cpu")[0])["actions"]
    check(summary["elastic_beats_static_spike_ramp"],
          "elastic sweep: elastic does not beat static on spike and ramp "
          f"({json.dumps({k: v for k, v in summary.items() if 'spike' in k or 'ramp' in k})})")
    check(summary["actions_per_trace"] == cpu_actions,
          f"elastic sweep: actions {summary['actions_per_trace']} != the "
          f"CPU run's {cpu_actions}")
    for r in rows[1:-1]:
        log(f"elastic sweep {r['trace']}/{r['mode']}: offered {r['offered']}"
            f", rejected {r['rejection_rate']:.4f}, SLO miss "
            f"{r['slo_miss_rate']:.4f} | TTFT p50/p95 {r['ttft_ticks_p50']}/"
            f"{r['ttft_ticks_p95']} ticks, p95 {r['ttft_p95_ms']:.3f} ms | "
            f"ITL p50/p95 {r['itl_ticks_p50']}/{r['itl_ticks_p95']} ticks, "
            f"p95 {r['itl_p95_ms']:.3f} ms | "
            f"{[a['kind'] for a in r['actions']]} | {r['wall_s']:.1f} s | "
            f"{card}")
    del params
    log(f"elastic sweep ({ELASTIC_SWEEP_LAYERS} layers): {wall:.1f} s on the "
        f"card | gates "
        f"{summary['elastic_beats_static_spike_ramp']}, ITL within 1.1x "
        f"{summary.get('itl_within_target')} | actions equal the CPU run's "
        f"| {card}")
    return {"rows": rows, "wall_s": wall, "cpu_actions": cpu_actions}


def run_elastic(torch, ops, args, card, report, launches, params=None,
                ref=None, lane=None):
    """The elastic fleet's phases at qwen3-0.6b's full width: request
    migration (bf16, int8), scale-in under load, engine recovery and the
    elastic sweep (its CPU run from the host lane ``lane``, if given),
    each with the launch counts set to 0 just before it and added to
    ``launches`` just after. ``ref`` is the undisturbed fleet's token
    streams (``phase_svff``'s reference); alone (from a script under
    ``build/``) it is served here once."""
    from repro_torch.configs import make_run_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request
    run = make_run_config("qwen3-0.6b", "decode_32k", seed=args.seed)
    device = torch.device("cuda")
    if params is None:
        params = build_model(run).init(seed=args.seed, device=device)
    workdir = tempfile.mkdtemp(prefix="elastic_smoke_")
    try:
        if ref is None:
            fleet = make_fleet(run, params, device,
                               os.path.join(workdir, "ref"))
            ref = drive_fleet(fleet, fleet_requests(
                Request, run.model.vocab_size, args.seed), {}, "reference")
            del fleet
            release(torch)
        report["elastic"] = {}
        for name, phase in (("migration", phase_migration),
                            ("scale_in", phase_scale_in),
                            ("recovery", phase_recovery)):
            ops.reset_launch_counts()
            report["elastic"][name] = phase(torch, run, params, args.seed,
                                            device, workdir, ref, card)
            counts = ops.launch_counts()
            report["elastic"][name]["launches"] = counts
            need = ELASTIC_KERNELS if name == "migration" else (
                "flash_attention", "paged_decode", "fused_sample")
            for k in need:
                check(counts[k] > 0, f"{k} was never launched on the "
                                     f"elastic {name} path")
            for k in ELASTIC_KERNELS:
                launches[k] = launches.get(k, 0) + counts[k]
        ops.reset_launch_counts()
        report["elastic"]["sweep"] = phase_elastic_sweep(torch, run, params,
                                                         device, card, lane)
        counts = ops.launch_counts()
        report["elastic"]["sweep"]["launches"] = counts
        for k in ("flash_attention", "paged_decode"):
            check(counts[k] > 0, f"{k} was never launched on the elastic "
                                 "sweep")
        for k in ELASTIC_KERNELS:
            launches[k] = launches.get(k, 0) + counts[k]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    release(torch)


# ---------------------------------------------------------------------------
# the serve plane's benchmarks and the dense ring, at full width
# ---------------------------------------------------------------------------
SERVE_PATH_KW = dict(requests=32, slots=16, max_len=1024, page_size=32,
                     max_new=24)     # the JAX benchmark's defaults
THROUGHPUT_STEPS = {"svff-bench": 20, "qwen3-0.6b": 10}
ROOFLINE_KERNELS = ("flash_decode", "paged_decode", "paged_decode_quant",
                    "fused_sample", "ssm_scan")


def first_difference(a: list, b: list) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def phase_dense(torch, ops, run, params, seed, paged, card):
    """The dense per-slot ring (``ServeEngine(paged=False)``) on the 16
    requests of the serve phase: fused sampling (launch counts), host
    sampling (I10: the same tokens) and a pause round trip (the same
    tokens). Its greedy streams are held against the paged engine's
    (``paged``: the bf16 serve phase's streams and metrics): where one
    diverges, the two tokens at the first difference must be a near tie
    of the teacher-forced logits there (within ``LOGITS_REL_TOL`` of max
    |logit|, the kernel-vs-plain prefill bound): the ring decodes
    through the plain attention, which rounds the probabilities to bf16
    before P V, the paged kernel keeps them fp32."""
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request
    out, met, counts = serve(torch, ops, run, params, None, seed,
                             count=True, paged=False)
    host, _, _ = serve(torch, ops, run, params, None, seed, fused=False,
                       paged=False)
    check(host == out, "dense ring: host sampling gives other tokens than "
                       "fused sampling (I10)")
    paused, _, _ = serve(torch, ops, run, params, None, seed, pause_at=10,
                         paged=False)
    check(paused == out, "dense ring: the pause round trip changed the "
                         "tokens (I10)")
    for k in ("flash_attention", "fused_sample"):
        check(counts[k] > 0, f"{k} was never launched on the dense ring")
    model = build_model(run)
    cp = model.compute_params(params)
    reqs = make_requests(Request, run.model.vocab_size, seed)
    greedy, diverged = 0, []
    for r, a, b in zip(reqs, out, paged["streams"]):
        if r.temperature > 0:
            continue
        greedy += 1
        if a == b:
            continue
        j = first_difference(a, b)
        toks = np.concatenate([r.prompt, np.asarray(a[:j], np.int32)])
        with torch.no_grad():
            _, lg = model.prefill(cp, {"tokens": torch.as_tensor(
                toks, dtype=torch.int64, device="cuda")[None]})
        lg = lg[0].float()
        gap = float((lg[a[j]] - lg[b[j]]).abs() / lg.abs().max())
        diverged.append({"rid": r.rid, "token": j, "dense": a[j],
                         "paged": b[j], "gap_rel": gap})
    del cp
    release(torch)
    res = dict(met, launches=counts, greedy_streams=greedy,
               greedy_equal_paged=greedy - len(diverged),
               greedy_diverged=diverged,
               paged_decode_step_ms_median=paged["decode_step_ms_median"])
    log(f"dense ring qwen3-0.6b: 16 requests x 32 tokens in {met['steps']} "
        f"steps, {met['wall_s']:.2f} s | decode step median "
        f"{met['decode_step_ms_median']:.2f} ms (paged "
        f"{paged['decode_step_ms_median']:.2f} ms) | {met['tokens_per_s']:.1f}"
        f" tokens/s | fused == host, pause round trip token-identical | "
        f"greedy streams equal the paged engine's: {greedy - len(diverged)} "
        f"of {greedy}" + "".join(
            f"; rid {d['rid']} first differs at token {d['token']} "
            f"(dense {d['dense']}, paged {d['paged']}, logit gap "
            f"{d['gap_rel']:.3g} of max |logit|)" for d in diverged)
        + f" | launches {json.dumps(counts)} | {card}")
    for d in diverged:
        check(d["gap_rel"] <= LOGITS_REL_TOL,
              f"dense ring: rid {d['rid']} leaves the paged engine's greedy "
              f"stream at token {d['token']} ({d['dense']} vs {d['paged']}) "
              f"where the logits differ by {d['gap_rel']:.3g} of max |logit|"
              f" (> {LOGITS_REL_TOL}): not a near tie")
    return res


SERVE_PATH_LAYERS = 4     # qwen3-0.6b at full width, 4 of its 28 layers:
                          # the identities hold at any depth, and at 28
                          # layers the bench took 111.6 s of the script's
                          # 1,200 on the H100 (PERF.md)


def phase_serve_path(torch, run, params, card):
    """``bench.serve_path`` at full width cut to SERVE_PATH_LAYERS (weights
    from the seed) with the JAX benchmark's defaults: the fused-sampling
    bit identities are hard; the wall-clock gates are reported (the fused
    int8 speedup against the JAX package's CPU figure, and the within-run
    one beside it)."""
    import dataclasses
    from repro_torch.bench import serve_path
    from repro_torch.models.model import build_model
    run = run.replace(model=dataclasses.replace(
        run.model, num_layers=SERVE_PATH_LAYERS))
    params = build_model(run).init(seed=run.seed, device="cuda")
    t0 = time.perf_counter()
    rows = serve_path.bench(device="cuda", run=run, params=params,
                            log=log, **SERVE_PATH_KW)
    del params
    s = rows[-1]
    gates = serve_path.wall_gates(s)
    res = {"rows": rows, "wall_gates": gates,
           "seconds": time.perf_counter() - t0}
    met = {k: "met" if v else "missed" for k, v in gates.items()}
    log(f"serve_path qwen3-0.6b, {SERVE_PATH_LAYERS} layers (slots 16, "
        f"max_len 1024, page 32, 32 x 24 "
        f"tokens): paged_speedup_vs_dense {s['paged_speedup_vs_dense']} "
        f"(JAX gate >= 1.5: {met['paged_speedup_vs_dense >= 1.5']}) | "
        f"live_pause_itl_p95_ratio {s['live_pause_itl_p95_ratio']} (JAX "
        f"gate <= 3.0: {met['live_pause_itl_p95_ratio <= 3.0']}) | "
        "fused_int8_speedup_vs_baseline "
        f"{s['fused_int8_speedup_vs_baseline']} against a CPU figure of "
        "the JAX package (reported, not held) | "
        f"fused_int8_speedup_vs_paged16 {s['fused_int8_speedup_vs_paged16']}"
        f" | fused bit-identical {s['fused_bit_identical']}, int8 "
        f"{s['fused_int8_bit_identical']} | {res['seconds']:.1f} s | {card}")
    check(serve_path.identities_hold(s), "serve_path: fused sampling gave "
          f"other tokens than host sampling (fused {s['fused_bit_identical']}"
          f", int8 {s['fused_int8_bit_identical']})")
    return res


def phase_prefix_share(torch, run, params, card):
    """``bench.prefix_share`` at full width: its page accounting (>= 3x
    capacity) and token identity are hard."""
    from repro_torch.bench import prefix_share
    t0 = time.perf_counter()
    rows = prefix_share.bench(device="cuda", run=run, params=params, log=log)
    s = rows[-1]
    res = {"rows": rows, "seconds": time.perf_counter() - t0}
    log(f"prefix_share qwen3-0.6b: capacity_ratio {s['capacity_ratio']} | "
        f"outputs bit-identical {s['outputs_bit_identical']} | cow splits "
        f"{s['cow_splits']}, shared page hits {s['shared_page_hits']} | "
        f"{res['seconds']:.1f} s | {card}")
    check(prefix_share.gates_hold(s), f"prefix_share: gates missed ({s})")
    return res


def phase_decode_roofline(torch, card):
    """``bench.decode_roofline`` at its full shapes, fp32 as the JAX rows,
    each row timed by the ``Timer`` (median of 25 calls, L2 flushed)
    against the H100's data sheet; the peaks the card reached
    (``measure_local_peaks``, the JAX sizes) are kept beside it. Hard: the
    five rows, wall_s > 0, the int8 pool at most 0.6x the fp32 pool's
    bytes, and no row above 1.0 of the data sheet; reported: the int8
    wall ratio (JAX gate <= 2.5)."""
    from repro_torch.bench import decode_roofline
    from repro_torch.runtime.roofline import Peaks, measure_local_peaks
    timer = Timer(torch)
    t0 = time.perf_counter()
    rows, ok = decode_roofline.bench(
        reduced=False, peaks=Peaks(), device="cuda", log=lambda *_: None,
        time_fn=lambda fn: timer.ms(fn) / 1e3)
    measured = measure_local_peaks(device="cuda")
    del timer
    s = rows[-1]
    res = {"rows": rows, "datasheet_peaks": Peaks().row(),
           "measured_peaks": measured.row(), "int8_wall_gate_met": ok,
           "seconds": time.perf_counter() - t0}
    log(f"decode_roofline (fp32 pages; data sheet {Peaks().hbm_bw / 1e12:.2f}"
        f" TB/s, {Peaks().flops / 1e12:.0f} TFLOP/s; measured copy "
        f"{measured.hbm_bw / 1e12:.3f} TB/s, fp32 512^2 matmul "
        f"{measured.flops / 1e12:.3f} TFLOP/s): " + ", ".join(
            f"{r['name']} {r['wall_s'] * 1e3:.4f} ms "
            f"{r['achieved_bw_frac']:.3f} of the sheet's bytes/s"
            for r in rows[:-1])
        + f" | int8_bytes_vs_fp {s['int8_bytes_vs_fp']}, int8_wall_vs_fp "
        f"{s['int8_wall_vs_fp']} (JAX gate <= 2.5: "
        f"{'met' if ok else 'missed'}) | {card}")
    check([r["name"] for r in rows[:-1]] == list(decode_roofline.ROWS),
          "decode_roofline: a row is missing")
    for r in rows[:-1]:
        check(r["wall_s"] > 0, f"decode_roofline: {r['name']} took no time")
        check(r["achieved_bw_frac"] <= 1.0 and r["peak_frac"] <= 1.0,
              f"decode_roofline: {r['name']} reads above the data sheet "
              f"({r['achieved_bw_frac']:.3f} of its bytes/s, "
              f"{r['peak_frac']:.3f} of its bound)")
    check(s["int8_bytes_vs_fp"] <= 0.6, "decode_roofline: the int8 pool's "
          f"bytes are {s['int8_bytes_vs_fp']} of the fp32 pool's (> 0.6)")
    return res


def phase_throughput(torch, arch, card, seed):
    """``bench.throughput`` (the paper's claim: a pause/unpause cycle
    leaves the step time unchanged) on ``arch``: svff-bench at its smoke
    widths as the JAX benchmark runs it, qwen3-0.6b at full width on 4 x
    512 (a 7.15 GB train state). Hard: after the cycle the state is
    bit-equal to a twin's that ran as many steps never paused. Reported:
    the overhead and the snapshot bytes, ms and GB/s."""
    from repro_torch.bench import throughput
    from repro_torch.tree import flatten
    full = arch != "svff-bench"
    batch, seq = (TRAIN_BATCH, TRAIN_SEQ) if full else (4, 64)
    steps = THROUGHPUT_STEPS[arch]
    t0 = time.perf_counter()
    out, tn = throughput.run_bench(steps, arch=arch, smoke=not full,
                                   local_batch=batch, seq_len=seq,
                                   device="cuda", seed=seed)
    workdir = tempfile.mkdtemp(prefix="tp_twin_")
    try:
        tw = throughput.twin(tn, steps, workdir, batch, seq)
        a, b = flatten(tn.export_state())[0], flatten(tw.export_state())[0]
        diff = [p for (p, x), (_, y) in zip(a, b)
                if not bits_equal(torch, x, y)]
        nleaves = len(a)
        del tw, a, b
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del tn
    release(torch)
    res = dict(out, arch=arch, batch=batch, seq=seq, steps=steps,
               leaves_differing=diff, seconds=time.perf_counter() - t0)
    log(f"throughput {arch} ({'full' if full else 'smoke'} widths, {batch} "
        f"x {seq}, {steps} steps a window): step "
        f"{out['step_ms_before_pause']:.2f} ms before the pause, "
        f"{out['step_ms_after_unpause']:.2f} ms after "
        f"({out['pause_cycle_overhead_pct']:+.2f}%) | snapshot none "
        f"{out['snapshot_none_bytes']:,} B {out['snapshot_none_ms']:.2f} ms "
        f"{out['snapshot_none_gbps']:.2f} GB/s, int8 "
        f"{out['snapshot_int8_bytes']:,} B {out['snapshot_int8_ms']:.2f} ms "
        f"{out['snapshot_int8_gbps']:.2f} GB/s (ratio "
        f"{out['compression_ratio']:.3f}) | {len(diff)} of {nleaves} leaves "
        f"differ from the never-paused twin | {res['seconds']:.1f} s | {card}")
    check(not diff, f"throughput {arch}: {len(diff)} leaves differ from the "
                    f"never-paused twin's ({diff[:4]})")
    return res


def run_serve_plane(torch, ops, args, card, report, launches, params,
                    paged):
    """The dense ring and the serve plane's benchmarks at qwen3-0.6b's full
    width, each with the launch counts set to 0 just before it and added
    to ``launches`` just after; ``paged`` is the bf16 serve phase's
    streams and decode-step median."""
    from repro_torch.configs import make_run_config
    run = make_run_config("qwen3-0.6b", "decode_32k", seed=args.seed)
    report["serve_plane"] = {}
    phases = (
        ("dense_ring", lambda: phase_dense(torch, ops, run, params,
                                           args.seed, paged, card),
         ("flash_attention", "fused_sample")),
        ("serve_path", lambda: phase_serve_path(torch, run, params, card),
         SERVE_KERNELS),
        ("prefix_share", lambda: phase_prefix_share(torch, run, params,
                                                    card),
         ("flash_attention", "paged_decode")),
        ("decode_roofline", lambda: phase_decode_roofline(torch, card),
         ROOFLINE_KERNELS),
        ("throughput_svff_bench",
         lambda: phase_throughput(torch, "svff-bench", card, args.seed),
         ("qdma_pack_rows",)),
        ("throughput_qwen3_0_6b",
         lambda: phase_throughput(torch, "qwen3-0.6b", card, args.seed),
         ("qdma_pack_rows",)))
    for name, phase, need in phases:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = phase()
        counts = ops.launch_counts()
        res["launches"] = counts
        res["phase_s"] = time.perf_counter() - t0
        report["serve_plane"][name] = res
        log(f"{name}: {res['phase_s']:.1f} s | launches {json.dumps(counts)}")
        for k in need:
            check(counts[k] > 0, f"{k} was never launched on the {name} "
                                 "path")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        release(torch)


# ---------------------------------------------------------------------------
# pipeline-parallel engines and the gang ops, at full width
# ---------------------------------------------------------------------------
PIPE_WIDTHS = (1, 2, 3, 4)
PIPE_MICROBATCHES = 2
PIPE_RESHAPE = {8: 3, 16: 2}   # engine step -> the width the live reshape sets
RESHAPE_STALL_RATIO = 0.5      # the JAX benchmark's gate: reported, not hard
PIPE_KERNELS = ("flash_attention", "paged_decode")
GANG_AT = {"attach_group": 4, "reshape": 8, "vf_loss": 12, "pause": 16}


def pipeline_engine(run, params, stages, kv_dtype=None, box=None):
    """A factory of a ``PipelineServeEngine`` at width ``stages`` with the
    serve phases' engine settings (8 slots, max_len 1024, page 16, host
    sampling), templates to K=4; the engine lands in ``box["eng"]``."""
    from repro_torch.serve.pipeline_engine import PipelineServeEngine

    def make():
        eng = PipelineServeEngine(
            run, params, device="cuda", stages=stages,
            max_stages=max(PIPE_WIDTHS), microbatches=PIPE_MICROBATCHES,
            slots=8, max_len=1024, page_size=16, kv_dtype=kv_dtype)
        if box is not None:
            box["eng"] = eng
        return eng
    return make


def pipe_row(eng, met, counts) -> dict:
    """One gang run's numbers: the decode-step median, the measured bubble
    beside the analytic one, the stage loads and the paged decode
    launches a decoding step."""
    from repro_torch.runtime.pipeline import bubble_fraction
    paged = counts["paged_decode"] + counts["paged_decode_quant"]
    return {"stages": eng.stage_width,
            "decode_step_ms_median": met["decode_step_ms_median"],
            "steps": met["steps"], "wall_s": met["wall_s"],
            "tokens_per_s": met["tokens_per_s"],
            "measured_bubble": eng.measured_bubble,
            "analytic_bubble": bubble_fraction(PIPE_MICROBATCHES,
                                               eng.stage_width),
            "stage_loads": list(eng.stage_loads()),
            "sched_ticks": eng.sched_ticks,
            "paged_decode_per_step": paged / max(met["decode_steps"], 1),
            "launches": counts}


PIPE_LAYERS = 8          # the K = 1-4 engines' qwen3-0.6b at full width,
                         # 8 of its 28 layers (2 a stage at K = 4): the
                         # streams are held against a single-stage engine
                         # on the same weights, and at 28 layers the group
                         # took 147.8 s of the script's 1,200 (PERF.md)


def phase_pipeline_serve(torch, ops, run, params, seed, card):
    """qwen3-0.6b's 16 serve requests, at full width cut to PIPE_LAYERS
    (weights from the seed), on a single-stage paged engine with
    host sampling (the oracle), then on ``PipelineServeEngine`` at K = 1,
    2, 3 and 4 (two microbatch groups): each K's streams equal the
    oracle's. Then a K=4 gang narrowed live to 3 and 2 mid-decode (its
    streams equal the oracle's; ``apply_reshape``'s wall beside a cold
    construction at K=3), and an int8-KV gang at K=2 against the
    single-stage int8 engine. The measured bubble is the GPipe recurrence
    over the items' walls: on one card the stages run one after another,
    so it is not idle time of the card. Each serve run sets the launch
    counts to 0 before it and reads them after; ``launches`` sums them."""
    from repro_torch.models.model import build_model
    run = run.replace(model=dataclasses.replace(
        run.model, num_layers=PIPE_LAYERS))
    params = build_model(run).init(seed=seed, device="cuda")
    res = {"widths": {}, "layers": PIPE_LAYERS}
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    oracle, met, counts = serve(torch, ops, run, params, None, seed,
                                fused=False, count=True)
    add(counts)
    res["oracle"] = dict(met, launches=counts)
    for k in PIPE_WIDTHS:
        box = {}
        out, met, counts = serve(torch, ops, run, params, None, seed,
                                 fused=False, count=True,
                                 engine=pipeline_engine(run, params, k,
                                                        box=box))
        check(out == oracle, f"pipeline K={k}: the streams differ from the "
                             "single-stage engine's")
        add(counts)
        row = pipe_row(box.pop("eng"), met, counts)
        res["widths"][k] = row
        release(torch)
        log(f"pipeline qwen3-0.6b K={k}: 16 requests x 32 tokens == the "
            f"single-stage engine's | decode step median "
            f"{row['decode_step_ms_median']:.2f} ms (single stage "
            f"{res['oracle']['decode_step_ms_median']:.2f}) | measured "
            f"bubble {row['measured_bubble']:.4f} (GPipe recurrence over "
            f"the item walls) vs analytic {row['analytic_bubble']:.4f} | "
            f"stage loads {[round(x, 4) for x in row['stage_loads']]} | "
            f"paged_decode {row['paged_decode_per_step']:.1f} a decoding "
            f"step | {card}")

    box, walls = {}, {}

    def narrow(eng, step):
        if step in PIPE_RESHAPE:
            t0 = time.perf_counter()
            eng.apply_reshape(PIPE_RESHAPE[step])
            walls[PIPE_RESHAPE[step]] = time.perf_counter() - t0

    out, met, counts = serve(torch, ops, run, params, None, seed,
                             fused=False, count=True, hook=narrow,
                             engine=pipeline_engine(run, params, 4, box=box))
    eng = box.pop("eng")
    add(counts)
    check(out == oracle, "live reshape 4 -> 3 -> 2: the streams differ from "
                         "the single-stage engine's")
    check(eng.stage_width == 2 and eng.reshape_count == 2,
          f"live reshape: width {eng.stage_width}, {eng.reshape_count} "
          "reshapes")
    del eng
    release(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = pipeline_engine(run, params, 3)()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    del cold
    release(torch)
    res["live_reshape"] = {
        "reshape_ms": {k: s * 1e3 for k, s in walls.items()},
        "cold_construction_ms": cold_s * 1e3,
        "stall_ratio": walls[3] / cold_s,
        "stall_ratio_gate": RESHAPE_STALL_RATIO,
        "stall_bounded": walls[3] / cold_s <= RESHAPE_STALL_RATIO,
        "decode_step_ms_median": met["decode_step_ms_median"],
        "launches": counts}
    log(f"pipeline live reshape 4 -> 3 -> 2 mid-decode: streams == the "
        f"single-stage engine's | apply_reshape {walls[3] * 1e3:.4f} ms "
        f"(to 3), {walls[2] * 1e3:.4f} ms (to 2) vs a cold construction "
        f"at K=3 {cold_s * 1e3:.2f} ms: ratio {walls[3] / cold_s:.6f} "
        f"(JAX gate <= {RESHAPE_STALL_RATIO}: "
        f"{'met' if res['live_reshape']['stall_bounded'] else 'missed'}) "
        f"| {card}")

    want8, met8, _ = serve(torch, ops, run, params, "int8", seed,
                           fused=False)
    box = {}
    out, met, counts = serve(torch, ops, run, params, "int8", seed,
                             fused=False, count=True,
                             engine=pipeline_engine(run, params, 2, "int8",
                                                    box=box))
    check(out == want8, "int8 gang K=2: the streams differ from the "
                        "single-stage int8 engine's")
    check(counts["paged_decode_quant"] > 0,
          "paged_decode_quant was never launched by the int8 gang")
    add(counts)
    res["int8_k2"] = dict(pipe_row(box.pop("eng"), met, counts),
                          single_stage_decode_step_ms_median=met8[
                              "decode_step_ms_median"])
    release(torch)
    log(f"pipeline int8 KV K=2: streams == the single-stage int8 engine's "
        f"| decode step median {met['decode_step_ms_median']:.2f} ms "
        f"(single stage {met8['decode_step_ms_median']:.2f}) | "
        f"paged_decode_quant {counts['paged_decode_quant']} | {card}")
    res["launches"] = total
    return res


def make_gang_fleet(run, params, device, workdir):
    """Two gang engines of qwen3-0.6b (K=2, templates to K=3, 8 slots,
    max_len 1024, page 16, host sampling) and a parked spare gang, on
    seven logical slots: the two gangs take four, the spare's attach two,
    the grow reshape the last."""
    from repro_torch.serve.fleet import ServeFleet
    return ServeFleet(run, params, num_engines=2, num_devices=7, num_vfs=7,
                      stages=2, max_stages=3,
                      microbatches=PIPE_MICROBATCHES, spare_engines=1,
                      slots=8, max_len=1024, page_size=16, device=device,
                      workdir=workdir)


def phase_gang_fleet(torch, run, params, seed, device, workdir, ref, card):
    """The gang fleet serves the SVFF phases' 32 requests while, mid-
    traffic, the spare gang lead attaches whole (``attach_group``),
    ``reshape_engine`` grows serve0 to K=3, ``handle_vf_loss`` sheds
    serve0's first shell (K=2), and serve1, a gang lead, is live-paused
    (two pre-copy rounds) and unpaused: every stream equals the
    undisturbed single-stage fleet's (``ref``; fused sampling there, host
    here, which give the same tokens), and the pause frees at least the
    engine's params, compute copy and pools. After the traffic, serve0
    and serve1 pause through the int8 staging engine (a live pause with
    digest dirty tracking and stream transport, then a pause with
    ``pipeline=False``): each restored leaf within its int8 bound."""
    from repro_torch.core.staging import StagingEngine
    from repro_torch.serve.engine import Request
    fleet = make_gang_fleet(run, params, device, workdir)
    slog = StagingLog(fleet.mgr.staging)
    res = {}

    def attach():
        lead = fleet.tenants["serve2"]
        t = fleet.mgr.attach_group(lead)
        check(lead.status == "running" and lead.stage_width == 2,
              "attach_group: the spare gang did not attach whole")
        res["attach_group"] = {"ms": t.total * 1e3,
                               "phases_ms": {k: v * 1e3
                                             for k, v in t.phases.items()}}

    def grow():
        info = fleet.reshape_engine("serve0", 3)
        check(fleet.tenants["serve0"].stage_width == 3,
              "reshape_engine: serve0 is not at K=3")
        res["reshape_engine"] = {"ms": info["reshape_s"] * 1e3,
                                 "added": info["added"]}

    def vf_loss():
        tn = fleet.tenants["serve0"]
        info = fleet.handle_vf_loss("serve0", tn.gang_shells[0].vf_id)
        check(tn.stage_width == 2 and info["dropped"] == ["serve0.s1"],
              f"handle_vf_loss: serve0 at K={tn.stage_width}, dropped "
              f"{info['dropped']}")
        res["handle_vf_loss"] = {"ms": info["reshape_s"] * 1e3,
                                 "dropped": info["dropped"]}

    def pause():
        eng = fleet.tenants["serve1"].engine
        state = engine_bytes(torch, eng)
        m0 = allocated(torch, device)
        n0, r0 = len(slog.saves), len(slog.restores)
        t = fleet.pause_live("serve1", rounds=2)
        m1 = allocated(torch, device)
        check(eng.params is None and eng._cparams is None
              and eng._cache is None and eng._sparams is None,
              "a paused gang lead kept a device tree or its stage views")
        fleet.step()                      # the other gangs serve meanwhile
        tu = fleet.unpause("serve1")
        m2 = allocated(torch, device)
        check(m0 - m1 >= state, f"gang lead pause freed {m0 - m1} of the "
                                f"engine's {state} device bytes")
        res["pause_live"] = {
            "stop_ms": t.stop_ms, "total_ms": t.total * 1e3,
            "unpause_ms": tu.total * 1e3, "engine_bytes": state,
            "freed_bytes": m0 - m1, "back_bytes": m2 - m1,
            "saves": transfer_row(slog.saves[n0:]),
            "restores": transfer_row(slog.restores[r0:])}

    out = drive_fleet(fleet, fleet_requests(Request, run.model.vocab_size,
                                            seed),
                      {GANG_AT["attach_group"]: attach,
                       GANG_AT["reshape"]: grow,
                       GANG_AT["vf_loss"]: vf_loss,
                       GANG_AT["pause"]: pause}, "gang fleet")
    check(out == ref, "gang fleet: a gang op changed the tokens (I10)")
    from repro_torch.sim import check_invariants
    check_invariants(fleet.mgr)                            # I1-I14

    for tid, live, engine in (
            ("serve0", True, StagingEngine(
                compression="int8", block=QDMA_BLOCK, incremental=True,
                dirty="digest", transport="stream")),
            ("serve1", False, StagingEngine(
                compression="int8", block=QDMA_BLOCK, pipeline=False))):
        fleet.mgr.staging = engine
        ilog = StagingLog(engine, keep=True)
        tn = fleet.tenants[tid]
        t = (fleet.pause_live(tid, rounds=2) if live
             else fleet.mgr.pause(tn))
        exported, ilog.last_tree = ilog.last_tree, None
        tu = fleet.unpause(tid)
        share = int8_bound(torch, exported, tn.engine, engine, tid)
        res[f"int8_pause_{tid}"] = {
            "live": live, "stop_ms": t.stop_ms, "total_ms": t.total * 1e3,
            "unpause_ms": tu.total * 1e3,
            "saves": transfer_row(ilog.saves),
            "restores": transfer_row(ilog.restores),
            "int8_bound_share": share}
    check(not fleet.mgr.journal.pending(), "gang fleet: journal entries "
                                           "left pending")
    p = res["pause_live"]
    log(f"gang fleet qwen3-0.6b (2 gangs K=2, templates to 3, a spare): 32 "
        f"requests == the undisturbed single-stage fleet's | attach_group "
        f"{res['attach_group']['ms']:.2f} ms | reshape_engine 2 -> 3 "
        f"{res['reshape_engine']['ms']:.2f} ms | handle_vf_loss 3 -> 2 "
        f"{res['handle_vf_loss']['ms']:.2f} ms | pause_live stop "
        f"{p['stop_ms']:.2f} ms of {p['total_ms']:.2f}, unpause "
        f"{p['unpause_ms']:.2f} ms, freed {p['freed_bytes']:,} of "
        f"{p['engine_bytes']:,} B, staging {p['saves']['gb_per_s']:.2f} "
        f"GB/s save, {p['restores']['gb_per_s']:.2f} GB/s restore | int8 "
        f"pauses within bound (shares "
        f"{res['int8_pause_serve0']['int8_bound_share']:.4f}, "
        f"{res['int8_pause_serve1']['int8_bound_share']:.4f}) | {card}")
    return res


def phase_sim_reshape(card, device, budget_s: float):
    """Scenarios with the pipeline gang lead ``pg0`` (the JAX gang
    scenarios' config: 45 ops, serve 0.3, reshape 0.25, crash 0.06, 8
    VFs), three policies, seeds until ``budget_s``: I1-I14 after every op
    inside the runner, every tenant's state on ``device``, and every
    non-chaos op accepted."""
    from repro_torch.sim import ScenarioConfig, ScenarioRunner
    rows = {}
    per = budget_s / len(SIM_POLICIES)
    for policy in SIM_POLICIES:
        t0 = time.perf_counter()
        seeds = ops = reshapes = rejected = 0
        while time.perf_counter() - t0 < per or seeds < 2:
            res = ScenarioRunner(ScenarioConfig(
                seed=seeds, policy=policy, num_ops=45, serve_rate=0.3,
                reshape_rate=0.25, crash_rate=0.06, max_vfs=8),
                device=device).run()
            for r in res.ops:
                check(r.status == "ok" or r.op.chaos,
                      f"sim reshape seed {seeds} {policy}: a valid op was "
                      f"rejected: {r.op} -> {r.error}")
            ops += len(res.ops)
            reshapes += sum(1 for r in res.ops
                            if r.op.kind == "reshape" and r.status == "ok")
            rejected += res.num_rejected
            seeds += 1
        wall = time.perf_counter() - t0
        rows[policy] = {"seeds": seeds, "ops": ops, "reshapes": reshapes,
                        "rejected": rejected, "wall_s": wall,
                        "ops_per_sec": ops / wall}
        check(reshapes > 0, f"sim reshape {policy}: no reshape op ran")
        log(f"sim reshape {policy}: {seeds} seeds, {ops} ops ({reshapes} "
            f"reshapes, {rejected} chaos rejections) in {wall:.2f} s, "
            f"{ops / wall:.1f} ops/s | I1-I14 after every op, state on "
            f"{device} | {card}")
    return rows


def phase_pipeline_bench(torch, card):
    """``bench.pipeline_serve`` at the JAX driver's defaults on the card:
    its identities hard (every K and the live reshape token-identical,
    the modeled scaling monotonic), its wall-clock gates (bubble within
    slack, reshape stall) reported."""
    from repro_torch.bench import pipeline_serve
    rows = pipeline_serve.bench(device="cuda", log=log)
    summary = rows[-1]
    check(pipeline_serve.identities_hold(summary),
          f"bench.pipeline_serve: an identity failed ({summary})")
    log(f"bench.pipeline_serve (deepseek-67b smoke, 4 layers): identities "
        f"hold | bubble within slack at every K: "
        f"{summary['bubble_within_slack_all_k']} | reshape stall ratio "
        f"{summary['reshape_stall_ratio']} (bounded: "
        f"{summary['reshape_stall_bounded']}) | {card}")
    return {"rows": rows}


def run_pipeline(torch, ops, args, card, report, launches, params, ref,
                 lane):
    """The pipeline-parallel engines and the gang ops at qwen3-0.6b's full
    width, each phase with the launch counts set to 0 just before it and
    added to ``launches`` just after: the gang engines at K = 1-4, the
    live reshape and the int8 gang; the gang fleet with its ops and int8
    pauses (``ref``: the undisturbed fleet's streams); the reshape
    scenarios (from the host lane, ``lane``); ``bench.pipeline_serve``."""
    from repro_torch.configs import make_run_config
    run = make_run_config("qwen3-0.6b", "decode_32k", seed=args.seed)
    device = torch.device("cuda")
    report["pipeline"] = {}
    workdir = tempfile.mkdtemp(prefix="gang_smoke_")
    phases = (
        ("serve", lambda: phase_pipeline_serve(torch, ops, run, params,
                                               args.seed, card),
         PIPE_KERNELS + ("paged_decode_quant",)),
        ("gang_fleet", lambda: phase_gang_fleet(torch, run, params,
                                                args.seed, device, workdir,
                                                ref, card),
         PIPE_KERNELS + QDMA_KERNELS),
        ("sim_reshape", lambda: lane_phase(lane, "sim_reshape"), ()),
        ("bench", lambda: phase_pipeline_bench(torch, card), PIPE_KERNELS))
    try:
        for name, phase, need in phases:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = phase()
            # the serve phase sums its serve runs' counts itself, the
            # lane's phase brings its own
            counts = res.setdefault("launches", ops.launch_counts())
            res["phase_s"] = time.perf_counter() - t0
            report["pipeline"][name] = res
            log(f"pipeline {name}: {res['phase_s']:.1f} s | launches "
                f"{json.dumps(counts)}")
            for k in need:
                check(counts[k] > 0, f"{k} was never launched on the "
                                     f"pipeline {name} path")
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            release(torch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# the federation: hosts, cross-host request migration, the fed sim plane
# ---------------------------------------------------------------------------
FED_PLAN = ("clean", "clean", "mid_ship", "clean", "after_admit", "clean",
            "mid_ship", "clean", "after_admit", "clean", "mid_ship",
            "clean", "after_admit", "clean")   # 8 clean, 3 + 3 deferred
FED_FROM = 3             # the first migration before this step,
FED_EVERY = 2            # then the plan's next one every this many steps
FED_WINDOWS = {"mid_ship": "fed_migrate_mid_ship",
               "after_admit": "fed_migrate_after_admit"}
FED_KERNELS = ("flash_attention", "paged_decode", "fused_sample")
#: the JAX package's fault-soup rates (tests/test_federation.py:240-245)
FED_SOUP = dict(num_ops=35, partition_rate=0.15, crash_rate=0.1,
                handoff_rate=0.05, migrate_rate=0.15, autoscale_rate=0.1)
FED_SCENARIO_S = 30.0    # the fed scenarios fill about this long
FED_MATRIX_SEEDS = 10    # the JAX acceptance matrix's seeds, 0-9
FED_MATRIX_CUT_S = 60.0  # past this, best_fit and fair_share take seeds 0-2
FED_MATRIX_CUT_SEEDS = 3
#: ``benchmarks/federation.py``'s defaults, the JAX artifact's scale
FED_BENCH = dict(hosts=8, engines_per_host=256, requests=120_000,
                 policy="fair_share", seed=0, partition_rate=0.05)
#: the JAX benchmark's fleet digests at FED_BENCH (``python
#: benchmarks/federation.py``; the committed BENCH_federation.json holds
#: the same two)
JAX_FED_DIGESTS = {"base": 1134344211, "faults": 521750552}
#: the keys of the JAX fleet's ``federation_snapshot`` payload and of its
#: bus replica (``src/repro/serve/fleet.py:572-579``,
#: ``src/repro/serve/telemetry.py:158-160``)
FED_SNAPSHOT_KEYS = ("capacity", "engines", "free_vfs", "host_id", "load",
                     "max_load", "stamp", "telemetry")
FED_REPLICA_KEYS = ("engines", "rejected_recent", "stamp")


def port_federation_kit(device) -> dict:
    """The port's classes for ``federation_engines``, engines on
    ``device``."""
    from repro_torch.core import (Fabric, FederationCoordinator, Host,
                                  HostUnreachableError)
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.fleet import EngineTenant
    from repro_torch.sim import (VirtualClock, check_invariants,
                                 federation_fingerprint)
    return dict(Host=Host, Coordinator=FederationCoordinator, Fabric=Fabric,
                Clock=VirtualClock, Tenant=EngineTenant,
                Unreachable=HostUnreachableError,
                check_invariants=check_invariants,
                fingerprint=federation_fingerprint,
                engine=lambda run, params, **kw: ServeEngine(
                    run, params, device=device, **kw))


def _fed_ownership(tns, live, deferred):
    """The I15 witness over the two engines (``check_federation`` cannot
    see them: ``Host.serve_targets`` admits only tenants with
    ``submit_request``): every live rid is served — queued, or active and
    not frozen — by exactly one engine; a deferred mid-ship rid by none;
    a deferred after-admit rid by its target alone (the target admitted
    it before the partition struck)."""
    serving = {}
    for tn in tns:
        eng = tn.engine
        frozen = set(eng._migrating)
        for r in list(eng.queue) + [r for r in eng.active if r is not None]:
            if r.rid not in frozen:
                serving.setdefault(r.rid, []).append(tn.tid)
    for rid in live:
        want = deferred.get(rid, "one")
        got = serving.get(rid, [])
        if want == "one":
            check(len(got) == 1, f"federation: request {rid} served by "
                                 f"{got}, not by exactly one engine (I15)")
        else:
            check(got == want, f"federation: deferred request {rid} served "
                               f"by {got}, want {want} (I15)")


def federation_engines(kit, run, params, workdir, reqs, *, slots=8,
                       max_len=1024, page_size=16, fused=True,
                       sync=lambda: None) -> dict:
    """Two ``Host``s, h0 and h1, on one ``VirtualClock`` and one ``Fabric``,
    each holding one paged engine tenant (``slots`` slots, bf16 KV,
    ``fused`` sampling; the engines share ``params``) under its own
    manager, adopted, under one ``FederationCoordinator``. Request i
    arrives at h0's engine before step i * ARRIVE_EVERY. From step
    FED_FROM, every FED_EVERY steps the next migration of FED_PLAN runs
    through ``co.migrate_request(src_host, dst_host, rid, src_tid=,
    dst_tid=)``: a clean one (h0 -> h1 and h1 -> h0 in turn, where the
    turn's source has a migratable request and its target a free slot),
    or one interrupted by an armed fault window (a request no window took
    before): it must raise ``HostUnreachableError`` and leave one deferred
    ``migrate_request`` entry carrying ``dst_host`` with the source slot
    frozen; then heal, ``heartbeat_all`` and ``recover()``: a mid-ship
    request resumes on the source, an after-admit one on the target, the
    source's copy freed, no entry pending, and a second ``recover()``
    leaves ``federation_fingerprint`` unchanged (I16). The ownership
    witness runs at every quiescent point. ``kit`` holds the classes
    (``port_federation_kit``, or the JAX package's in a CPU test).
    Returns the token streams, the migrations and both journals."""
    clock, fabric = kit["Clock"](), kit["Fabric"]()
    hosts, tns = [], []
    for i in range(2):
        hid = f"h{i}"
        host = kit["Host"](hid, workdir=os.path.join(workdir, hid),
                           clock=clock, num_devices=2, max_vfs=2)
        eng = kit["engine"](run, params, slots=slots, max_len=max_len,
                            paged=True, page_size=page_size,
                            fused_sampling=fused)
        tn = kit["Tenant"](f"{hid}.serve0", eng)
        host.mgr.init(num_vfs=1, tenants=[tn])
        host.adopt({tn.tid: tn})
        hosts.append(host)
        tns.append(tn)
    co = kit["Coordinator"](hosts, clock=clock, fabric=fabric)
    co.heartbeat_all()
    plan = list(FED_PLAN)
    migrations, faulted = [], set()
    arrived, steps, clean_turn = [], 0, 0

    def live():
        return [r.rid for r in arrived if not r.done]

    def candidate(i, exclude=()):
        """A migratable rid on engine i whose target has a free slot."""
        dst = tns[1 - i].engine
        if sum(r is not None for r in dst.active) >= slots:
            return None
        for r in tns[i].engine.active:
            if (r is not None and r.rid not in exclude
                    and tns[i].peek_migratable(r.rid) is not None):
                return r.rid
        return None

    def migrate(kind) -> bool:
        nonlocal clean_turn
        if kind == "clean":
            order = (clean_turn % 2, 1 - clean_turn % 2)
            exclude = ()
        else:
            order, exclude = (0, 1), faulted
        pick = next(((i, rid) for i in order
                     if (rid := candidate(i, exclude)) is not None), None)
        if pick is None:
            return False
        i, rid = pick
        src, dst = hosts[i], hosts[1 - i]
        kw = dict(src_tid=tns[i].tid, dst_tid=tns[1 - i].tid)
        if kind == "clean":
            clean_turn += 1
            sync()
            t0 = time.perf_counter()
            out = co.migrate_request(src.host_id, dst.host_id, rid, **kw)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            last = src.mgr.journal.entries()[-1]
            check(out["rid"] == rid and out["dst_host"] == dst.host_id
                  and last["op"] == "migrate_request"
                  and last["status"] == "committed"
                  and last["details"].get("dst_host") == dst.host_id,
                  f"federation: clean migration of {rid} {out} / {last}")
            migrations.append({"kind": kind, "rid": rid, "src": src.host_id,
                               "dst": dst.host_id, "ms": ms,
                               "blocks": out["blocks"]})
            return True
        window = FED_WINDOWS[kind]
        faulted.add(rid)
        fabric.arm(window, [co.node_id, src.host_id], [dst.host_id])
        try:
            co.migrate_request(src.host_id, dst.host_id, rid, **kw)
            check(False, f"federation: {window} never interrupted the "
                         f"migration of {rid}")
        except kit["Unreachable"]:
            pass
        check(fabric.fired[-1:] == [window],
              f"federation: {window} never fired ({fabric.fired})")
        deferred = [e for e in src.mgr.journal.pending()
                    if e["details"].get("deferred_cross_host")]
        check(len(deferred) == 1 and deferred[0]["op"] == "migrate_request"
              and deferred[0]["details"].get("rid") == rid
              and deferred[0]["details"].get("dst_host") == dst.host_id,
              f"federation: {window}: no deferred entry for {rid} "
              f"carrying dst_host ({deferred})")
        check(rid in tns[i].engine._migrating,
              f"federation: {window}: source slot of {rid} not frozen")
        forward = kind == "after_admit"
        _fed_ownership(tns, live(),
                       {rid: [tns[1 - i].tid] if forward else []})
        fabric.heal()
        co.heartbeat_all()
        co.recover()
        fp = kit["fingerprint"](hosts, co)
        co.recover()
        check(kit["fingerprint"](hosts, co) == fp,
              f"federation: {window}: a second recover changed the "
              "fingerprint (I16)")
        owner = tns[1 - i] if forward else tns[i]
        owners = [tn.tid for tn in tns if tn.owns_request(rid)]
        check(owners == [owner.tid],
              f"federation: {window}: {rid} owned by {owners}, want "
              f"[{owner.tid}]")
        check(not any(h.mgr.journal.pending() for h in hosts)
              and rid not in tns[i].engine._migrating,
              f"federation: {window}: the deferred entry or the frozen "
              "slot survived the post-heal recover")
        if forward:
            check(not tns[i].engine.alloc.pages_of(rid),
                  f"federation: {window}: the source kept pages of {rid}")
        migrations.append({"kind": kind, "rid": rid, "src": src.host_id,
                           "dst": dst.host_id,
                           "resumed_on": owner.tid})
        return True

    engines = [tn.engine for tn in tns]
    while steps < 4000:
        k = steps // ARRIVE_EVERY
        if steps % ARRIVE_EVERY == 0 and k < len(reqs):
            engines[0].submit(reqs[k])
            arrived.append(reqs[k])
        if (plan and steps >= FED_FROM
                and (steps - FED_FROM) % FED_EVERY == 0):
            if migrate(plan[0]):
                plan.pop(0)
        _fed_ownership(tns, live(), {})
        for eng in engines:
            eng.step()
        co.heartbeat_all()
        steps += 1
        if (len(arrived) == len(reqs) and not plan
                and not any(e.queue or any(r is not None for r in e.active)
                            for e in engines)):
            break
    check(not plan, f"federation: the plan's migrations {plan} never found "
                    "a migratable request")
    check(all(r.done and r.error is None for r in reqs),
          "federation: not every request completed")
    for host in hosts:
        kit["check_invariants"](host.mgr)
    journals = {h.host_id: [(e["op"], e["tenant"], e["status"],
                             e["details"].get("recovered"),
                             e["details"].get("dst_host"),
                             e["details"].get("rid"))
                            for e in h.mgr.journal.entries()]
                for h in hosts}
    return {"streams": [list(r.out) for r in reqs], "steps": steps,
            "migrations": migrations, "journals": journals,
            "hosts": hosts, "tenants": tns}


def phase_federation_engines(torch, run, params, seed, workdir, paged, card):
    """``federation_engines`` at qwen3-0.6b's full width on the card, with
    the 16 serve requests: every stream equals the undisturbed paged bf16
    engine's (``paged``, the serve phase's), the clean migrations' ms
    logged (median and range)."""
    from repro_torch.serve.engine import Request
    reqs = make_requests(Request, run.model.vocab_size, seed)
    res = federation_engines(port_federation_kit(torch.device("cuda")), run,
                             params, workdir, reqs,
                             sync=torch.cuda.synchronize)
    check(res["streams"] == paged["streams"],
          "federation: a cross-host migration changed the tokens (the "
          "streams differ from the undisturbed paged bf16 engine's)")
    for tn in res["tenants"]:
        check(all(t.device.type == "cuda" for blk in tn.engine._cache.values()
                  for t in blk.values() if isinstance(t, torch.Tensor)),
              f"federation: {tn.tid}'s pages left the card")
    migs = res["migrations"]
    clean = [m for m in migs if m["kind"] == "clean"]
    ms = [m["ms"] for m in clean]
    out = {"steps": res["steps"], "migrations": migs,
           "journals": res["journals"],
           "clean": len(clean),
           "directions": sorted({(m["src"], m["dst"]) for m in clean}),
           "rolled_back": sum(m["kind"] == "mid_ship" for m in migs),
           "rolled_forward": sum(m["kind"] == "after_admit" for m in migs),
           "migrate_ms_median": float(np.median(ms)),
           "migrate_ms_min": min(ms), "migrate_ms_max": max(ms),
           "streams_equal": len(reqs)}
    check(out["clean"] >= 8 and len(out["directions"]) == 2
          and out["rolled_back"] == 3 and out["rolled_forward"] == 3,
          f"federation: migrations {out['clean']} clean in "
          f"{out['directions']}, {out['rolled_back']} rolled back, "
          f"{out['rolled_forward']} rolled forward")
    log(f"federation qwen3-0.6b: {out['clean']} clean cross-host "
        f"migrations ({', '.join('->'.join(d) for d in out['directions'])})"
        f", cross-host migrate_request median {out['migrate_ms_median']:.2f}"
        f" ms (range {out['migrate_ms_min']:.2f}-{out['migrate_ms_max']:.2f}"
        f"); fed_migrate_mid_ship x3 deferred then rolled back, "
        f"fed_migrate_after_admit x3 deferred then rolled forward; "
        f"ownership witness at every step; {len(reqs)} streams equal the "
        f"undisturbed engine's; I1-I14 on both managers | {card}")
    return out


def phase_federation_snapshot(torch, run, params, seed, workdir, card):
    """``ServeFleet.federation_snapshot`` on a two-engine qwen3-0.6b fleet
    mid-traffic: load, capacity, stamps and keys."""
    from repro_torch.serve.engine import Request
    fleet = make_fleet(run, params, torch.device("cuda"), workdir)
    for r in make_requests(Request, run.model.vocab_size, seed)[:6]:
        fleet.submit(r)
    for _ in range(3):
        fleet.step()
    now = 12.5
    snap = fleet.federation_snapshot(now)
    running = [tn for tn in fleet.tenants.values() if tn.status == "running"]
    check(snap["load"] == sum(tn.load for tn in running) > 0,
          f"federation_snapshot: load {snap['load']}")
    check(snap["capacity"] == fleet.slo_max_load * len(running),
          f"federation_snapshot: capacity {snap['capacity']}")
    check(snap["stamp"] == now and snap["telemetry"]["stamp"] == now,
          f"federation_snapshot: stamps {snap['stamp']} / "
          f"{snap['telemetry']['stamp']}, want {now}")
    check(tuple(sorted(snap)) == FED_SNAPSHOT_KEYS
          and tuple(sorted(snap["telemetry"])) == FED_REPLICA_KEYS,
          f"federation_snapshot: keys {sorted(snap)} / "
          f"{sorted(snap['telemetry'])}")
    fleet.drain()
    out = {k: snap[k] for k in ("host_id", "stamp", "load", "capacity",
                                "max_load", "free_vfs", "engines")}
    log(f"federation_snapshot: {json.dumps(out)} (load and capacity over "
        f"{len(running)} running engines, the bus replica stamped "
        f"{now}, the JAX payload's keys) | {card}")
    del fleet
    return out


def phase_fed_scenarios(card, device, budget_s: float):
    """``FedRunner`` over the three policies at the JAX fault-soup rates
    with the sim state on ``device`` (I1-I15 after every op, I16 on every
    host crash, every running tenant's state on ``device``), seeds until
    ``budget_s``; each seed's fingerprint, counters and epoch equal a CPU
    run of the same config."""
    from repro_torch.sim import FedScenarioConfig, FedRunner
    keys = ("fingerprint", "submitted", "rejected", "deferred", "epoch")
    rows = {}
    per = budget_s / len(SIM_POLICIES)
    for policy in SIM_POLICIES:
        t0 = time.perf_counter()
        seeds = ops = 0
        card_s = 0.0
        while time.perf_counter() - t0 < per or seeds < 2:
            cfg = FedScenarioConfig(seed=seeds, policy=policy, **FED_SOUP)
            t1 = time.perf_counter()
            got = FedRunner(cfg, device=device).run()
            card_s += time.perf_counter() - t1
            want = FedRunner(cfg, device="cpu").run()
            check({k: got[k] for k in keys} == {k: want[k] for k in keys}
                  and got["rows"] == want["rows"],
                  f"fed scenario seed {seeds} {policy}: the card's run "
                  f"{ {k: got[k] for k in keys} } != the CPU's "
                  f"{ {k: want[k] for k in keys} }")
            ops += got["ops"]
            seeds += 1
        rows[policy] = {"seeds": seeds, "ops": ops, "card_s": card_s,
                        "ops_per_sec": ops / card_s}
        log(f"fed scenarios {policy}: {seeds} seeds x {FED_SOUP['num_ops']} "
            f"ops on {device} in {card_s:.2f} s, {ops / card_s:.1f} ops/s; "
            f"fingerprints, counters and rows equal the CPU runs; I1-I15 "
            f"after every op, I16 on every host crash | {card}")
    return rows


def phase_fed_matrix(card, device):
    """Every window of ``NETWORK_FAULTS`` x seeds 0-9 x three policies on
    ``device``, each cell green (the catalogued outcome, I15 during the
    fault, I16 after the heal, I10 for every touched request). When
    first_fit's 70 cells say the 210 would pass FED_MATRIX_CUT_S,
    best_fit and fair_share take seeds 0-2 (112 cells)."""
    from repro_torch.sim import NETWORK_FAULTS, network_fault_matrix
    t0 = time.perf_counter()
    rep = {"first_fit": network_fault_matrix(
        seeds=range(FED_MATRIX_SEEDS), policies=("first_fit",),
        device=device)}
    first = time.perf_counter() - t0
    seeds = (FED_MATRIX_SEEDS if first * len(SIM_POLICIES)
             <= FED_MATRIX_CUT_S else FED_MATRIX_CUT_SEEDS)
    for policy in SIM_POLICIES[1:]:
        rep[policy] = network_fault_matrix(seeds=range(seeds),
                                           policies=(policy,),
                                           device=device)
    wall = time.perf_counter() - t0
    cells = sum(r["summary"]["num_cases"] for r in rep.values())
    fails = sum(r["summary"]["num_failures"] for r in rep.values())
    want = len(NETWORK_FAULTS) * (FED_MATRIX_SEEDS + 2 * seeds)
    check(fails == 0 and cells == want,
          f"network-fault matrix: {fails} of {cells} cells failed")
    out = {"cells": cells, "failures": fails, "wall_s": wall,
           "seeds": {"first_fit": FED_MATRIX_SEEDS, "best_fit": seeds,
                     "fair_share": seeds},
           "cut": seeds != FED_MATRIX_SEEDS}
    log(f"network-fault matrix: {len(NETWORK_FAULTS)} windows x seeds "
        f"{json.dumps(out['seeds'])} = {cells} cells green on {device} in "
        f"{wall:.2f} s{' (cut: 210 cells would pass 60 s)' if out['cut'] else ''}"
        f" | {card}")
    return out


# ---------------------------------------------------------------------------
# the lanes: groups in processes of their own beside this process's groups.
# The host lane runs the phases whose work is Python on the host; the model
# lane the hybrid and families groups, whose models hold no state of the
# groups here.
# ---------------------------------------------------------------------------
LANE_TIMEOUT_S = 900.0   # the most a group waits for one of a lane's jobs
LANES = {"host": "the host lane", "models": "the model lane"}
LANE_END = "end"          # what a lane puts after its last job


def model_group(torch, ops, args, card, run_group) -> dict:
    """``run_group`` (``run_hybrid`` or ``run_families``) as a model lane
    job: its report and the launch counts of its paths."""
    report, launches = {}, {}
    run_group(torch, ops, args, card, report, launches)
    return {"report": report, "launches": launches}


def lane_jobs(torch, ops, card, which: str, args):
    """The jobs of the lane ``which`` in the order it runs them, each
    (name, call). The host lane: the elastic sweep's CPU run, the sim
    plane's scenarios, matrices and sweeps (their small state on the
    card, every invariant checked on the host) and ``bench.federation``
    (its engines hold no tensor); no kernel of the port runs in them. The model lane: the hybrid group, then the
    families group (``args``: this script's arguments)."""
    device = torch.device("cuda")
    if which == "models":
        return (("hybrid", lambda: model_group(torch, ops, args, card,
                                               run_hybrid)),
                ("families", lambda: model_group(torch, ops, args, card,
                                                 run_families)))
    return (
        ("elastic_cpu", elastic_cpu_actions),
        ("sim_reshape", lambda: phase_sim_reshape(card, device,
                                                  SIM_SERVE_SWEEP_S)),
        ("fed_scenarios", lambda: phase_fed_scenarios(card, device,
                                                      FED_SCENARIO_S)),
        ("fed_matrix", lambda: phase_fed_matrix(card, device)),
        ("fed_bench", lambda: fed_bench_rows()),
        ("sim_crash", lambda: phase_sim_crash(card, device)),
        ("sim_sweep", lambda: phase_sim_sweep(torch, card, device,
                                              SIM_SWEEP_S)),
        ("sim_sweep_serve_crash", lambda: phase_sim_sweep(
            torch, card, device, SIM_SERVE_SWEEP_S, serve_rate=0.3,
            crash_rate=0.1)))


def lane_worker(card, which, args, results):
    """The jobs of the lane ``which`` (``lane_jobs``) one after another in
    a spawned process, each with the launch counts set to 0 just before
    it: puts (name, result, its printed lines, its launch counts, seconds)
    on ``results``, or (name, the traceback, ...) and stops."""
    import contextlib
    import io
    import traceback
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one thread: the lanes share the host's cores with this process
    torch.set_num_threads(1)
    for name, job in lane_jobs(torch, ops, card, which, args):
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                res = job()
        except BaseException:
            results.put((name, traceback.format_exc(), buf.getvalue(), {},
                         time.perf_counter() - t0))
            raise
        results.put((name, res, buf.getvalue(), ops.launch_counts(),
                     time.perf_counter() - t0))
    results.put((LANE_END, None, "", {}, 0.0))


def start_lane(card, which: str = "host", args=None) -> dict:
    """Start ``lane_worker`` for the lane ``which`` beside this process's
    groups (~1 core each: the host lane for ~4-5 minutes, the model lane
    ~2-3); returns the job that ``lane_result`` reads and ``close_lane``
    joins."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # daemonic: ended with this process if a check fails before the close
    proc = ctx.Process(target=lane_worker, args=(card, which, args, results),
                       daemon=True)
    proc.start()
    return {"proc": proc, "results": results, "got": {},
            "what": LANES[which]}


def lane_take(lane, name: str):
    """Read the lane's results until its job ``name`` has put its own (or,
    for ``LANE_END``, every job has), keeping them unread."""
    import queue
    proc, results, got = lane["proc"], lane["results"], lane["got"]
    what = lane["what"]
    t0 = time.perf_counter()
    while name not in got:
        try:
            item = results.get(timeout=5.0)
        except queue.Empty:
            check(proc.exitcode in (None, 0), f"{what}'s process exited "
                  f"{proc.exitcode} before its {name} job's end")
            check(time.perf_counter() - t0 < LANE_TIMEOUT_S,
                  f"{what}'s {name} job took over "
                  f"{LANE_TIMEOUT_S:.0f} s more")
            continue
        check(not isinstance(item[1], str),
              f"{what}'s {item[0]} job failed:\n{item[1]}")
        got[item[0]] = item[1:]


def lane_wait(lane) -> float:
    """Wait until every job of the lane has ended; the seconds waited."""
    t0 = time.perf_counter()
    lane_take(lane, LANE_END)
    return time.perf_counter() - t0


def lane_result(lane, name: str):
    """(result, launch counts, {"lane_s", "waited_s"}) of the lane's job
    ``name``, its printed lines logged here; waits for it."""
    t0 = time.perf_counter()
    lane_take(lane, name)
    what = lane["what"]
    res, printed, counts, secs = lane["got"].pop(name)
    for line in printed.splitlines():
        log(line)
    waited = time.perf_counter() - t0
    log(f"{name}: {secs:.1f} s in {what}, waited {waited:.1f} s for it "
        "here")
    return res, counts, {"lane_s": secs, "waited_s": waited}


def lane_phase(lane, name: str) -> dict:
    """The host lane's job ``name`` as a group's phase: its result (a
    dict) with its launch counts and seconds."""
    res, counts, secs = lane_result(lane, name)
    return dict(res, launches=counts, **secs)


def lane_group(lane, name: str, report: dict, launches: dict):
    """The model lane's group ``name``: its report into ``report``, the
    launch counts of its paths added to ``launches``."""
    res, _, secs = lane_result(lane, name)
    report.update(res["report"])
    report[f"{name}_lane"] = secs
    for k, n in res["launches"].items():
        launches[k] = launches.get(k, 0) + n


def close_lane(lane):
    proc = lane["proc"]
    try:
        proc.join(timeout=60)
        check(proc.exitcode == 0,
              f"{lane['what']}'s process exited {proc.exitcode}")
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=30)


#: the commands started beside the groups (``start_command``), each ended
#: with every process it started if this process exits before reading it
COMMANDS = []


def start_command(argvs, what: str) -> dict:
    """Each argv of ``argvs`` as a process of its own session on the card,
    beside this process's groups, its output and errors to files; returns
    the job that ``finish_command`` reads."""
    import threading
    tmp = tempfile.mkdtemp(prefix="smoke_cmd_")
    job = {"what": what, "tmp": tmp, "procs": [], "outs": [],
           "t0": time.perf_counter()}
    # one thread a process: the commands share the host's cores
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        (os.path.join(ROOT, "src"), ROOT)), OMP_NUM_THREADS="1")
    for i, (argv, extra) in enumerate(argvs):
        out = [open(os.path.join(tmp, f"{i}.{k}"), "w+")
               for k in ("out", "err")]
        job["outs"].append(out)
        job["procs"].append(subprocess.Popen(
            argv, env=dict(env, **extra), stdout=out[0], stderr=out[1],
            text=True, start_new_session=True))
    COMMANDS.append(job)

    def wait():
        for p in job["procs"]:
            p.wait()
        job["end"] = time.perf_counter()
    job["thread"] = threading.Thread(target=wait, daemon=True)
    job["thread"].start()
    return job


def stop_command(job):
    """End the job's processes and every process they started, close and
    remove its files."""
    import signal
    for p in job["procs"]:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    for out in job["outs"]:
        for f in out:
            f.close()
    shutil.rmtree(job["tmp"], ignore_errors=True)
    if job in COMMANDS:
        COMMANDS.remove(job)


def finish_command(job, timeout_s: float) -> tuple:
    """(each process's output, seconds from the job's start to its last
    exit, seconds waited here) of ``job``, after its processes have
    exited; fails with the end of their errors unless each exited 0."""
    t0 = time.perf_counter()
    try:
        job["thread"].join(timeout_s)
        check(not job["thread"].is_alive(),
              f"{job['what']} took over {timeout_s:.0f} s more")
        outs = []
        for p, (out, err) in zip(job["procs"], job["outs"]):
            out.seek(0)
            err.seek(0)
            outs.append(out.read())
            check(p.returncode == 0, f"{job['what']} exited {p.returncode}:"
                                     f"\n{err.read()[-3000:]}")
    finally:
        stop_command(job)
    return outs, job["end"] - job["t0"], time.perf_counter() - t0


def stop_commands():
    for job in list(COMMANDS):
        stop_command(job)


def fed_bench_rows():
    """``bench.federation`` at ``FED_BENCH`` (a host lane job)."""
    from repro_torch.bench import federation
    return federation.bench(**FED_BENCH, reduced=False)


def phase_fed_bench(card, lane):
    """``bench.federation`` at the JAX artifact's scale (8 hosts x 256
    engines, 120,000 requests, fair_share, partition rate 0.05), from the
    host lane: every gate and the scale floor hold, base digest == rerun
    digest, and the base and faults digests equal the JAX benchmark's.
    The driver's engines are dict-backed: it runs on the host, not on the
    card."""
    rows, counts, secs = lane_result(lane, "fed_bench")
    base, rerun, faults, summary = rows
    check(summary["all_gates"] and all(summary["gates"].values())
          and all(summary["scale"].values()),
          f"bench.federation: a gate failed ({summary})")
    check(base["digest"] == rerun["digest"] == JAX_FED_DIGESTS["base"]
          and faults["digest"] == JAX_FED_DIGESTS["faults"],
          f"bench.federation: digests base {base['digest']} rerun "
          f"{rerun['digest']} faults {faults['digest']}, the JAX "
          f"benchmark's {JAX_FED_DIGESTS}")
    for r in (base, rerun, faults):
        log(f"bench.federation {r['run']}: {r['hosts']} hosts x "
            f"{r['engines'] // r['hosts']} engines, {r['admitted']:,} "
            f"admitted, {r['tokens']:,} tokens in {r['wall_s']:.3f} s: "
            f"{r['admits_per_s']:.1f} admits/s, {r['tokens_per_s']:.1f} "
            f"tokens/s on the host, in the host lane beside the card's "
            f"groups (the driver's engines hold no tensor); digest "
            f"{r['digest']} | card {card}")
    return {"rows": rows, "launches": counts, **secs}


def run_federation(torch, ops, args, card, report, launches, params, paged,
                   lane):
    """The federation group at qwen3-0.6b's full width, each phase with the
    launch counts set to 0 just before it and added to ``launches`` just
    after: two hosts' engines with cross-host migrations (``paged``: the
    undisturbed paged bf16 engine's streams), ``federation_snapshot``;
    then, from the host lane (``lane``), the fed scenarios and the
    network-fault matrix with the sim state on the card and
    ``bench.federation``."""
    from repro_torch.configs import make_run_config
    run = make_run_config("qwen3-0.6b", "decode_32k", seed=args.seed)
    report["federation"] = {}
    workdir = tempfile.mkdtemp(prefix="fed_smoke_")
    phases = (
        ("engines", lambda: phase_federation_engines(
            torch, run, params, args.seed, os.path.join(workdir, "fed"),
            paged, card), FED_KERNELS),
        ("snapshot", lambda: phase_federation_snapshot(
            torch, run, params, args.seed, os.path.join(workdir, "snap"),
            card), ()),
        ("scenarios", lambda: lane_phase(lane, "fed_scenarios"), ()),
        ("matrix", lambda: lane_phase(lane, "fed_matrix"), ()),
        ("bench", lambda: phase_fed_bench(card, lane), ()))
    t_group = time.perf_counter()
    try:
        for name, phase, need in phases:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = phase()
            # the lane's phases bring their own counts
            counts = res.setdefault("launches", ops.launch_counts())
            res["phase_s"] = time.perf_counter() - t0
            report["federation"][name] = res
            log(f"federation {name}: {res['phase_s']:.1f} s | launches "
                f"{json.dumps(counts)}")
            for k in need:
                check(counts[k] > 0, f"{k} was never launched on the "
                                     f"federation {name} path")
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            release(torch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    report["federation"]["group_s"] = time.perf_counter() - t_group
    log(f"federation group: {report['federation']['group_s']:.1f} s")


# ---------------------------------------------------------------------------
# the distributed runtime: ranks on the one card under gloo
# ---------------------------------------------------------------------------
DIST_RANKS = 4
DIST_BLOCK = 256                      # the JAX package's default block
DIST_BOUND = 0.5 / 127 * 1.15         # tests/test_collectives.py:87-89
DIST_EXACT_BOUND = 1e-6               # the exact path's, :45
DIST_TIMEOUT_S = 600.0
PIPE_APPLY_MICROBATCHES = 8
PIPE_APPLY_TOKENS = 384
DIST_KERNELS = {"collectives": ("qdma_pack", "qdma_unpack"),
                "pipeline_apply": ("flash_attention",)}


def replica_shapes(torch, run):
    """(path, ShapeDtype) of a replica's gradient leaves in sorted-key
    order, and the tree's definition: qwen3-0.6b's params in fp32, plus a
    7-value leaf (the JAX test's "tiny", which takes the exact path: qwen
    has no leaf under four blocks)."""
    from repro_torch.models.model import build_model
    from repro_torch.models.params import ShapeDtype
    from repro_torch.tree import flatten
    tree = {"params": build_model(run).param_shapes(),
            "tiny": ShapeDtype((7,), torch.float32)}
    return flatten(tree, is_leaf=lambda x: isinstance(x, ShapeDtype))


def replica_grads(torch, run, seed: int) -> dict:
    """One replica's gradient tree on the card: standard normal fp32
    leaves drawn in sorted-key order from a generator seeded with
    ``seed``."""
    from repro_torch.tree import unflatten
    flat, treedef = replica_shapes(torch, run)
    gen = torch.Generator(device="cuda").manual_seed(int(seed))
    return unflatten(treedef, [torch.randn(sd.shape, generator=gen,
                                           device="cuda")
                               for _, sd in flat])


def tree_sha256(torch, tree) -> str:
    import hashlib
    from repro_torch.tree import flatten
    h = hashlib.sha256()
    for _, leaf in flatten(tree)[0]:
        h.update(leaf.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def rank_collectives(torch, ops, dist, run, rank, world, seed):
    """The compressed gradient all-reduce of this rank's replica: timed
    with the launch counts set to 0 just before it, then the same call with
    the plain pack and unpack (bit-equal), a plain fp32 all-reduce mean for
    the wall beside it, and (rank 0) each leaf against the fp64 mean of
    every replica, drawn again from the seeds."""
    from repro_torch.runtime.collectives import (WireStats,
                                                 compressed_grad_allreduce,
                                                 exact_mean)
    from repro_torch.tree import flatten, tree_map
    grads = replica_grads(torch, run, seed + rank)
    sync = torch.cuda.synchronize
    st = WireStats()
    # warm-up: the kernels' library loads, gloo's pairs connect
    compressed_grad_allreduce({"w": torch.ones(4 * DIST_BLOCK,
                                               device="cuda")})
    dist.barrier()
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    got = compressed_grad_allreduce(grads, block=DIST_BLOCK, stats=st)
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    plain = compressed_grad_allreduce(grads, block=DIST_BLOCK, backend="ref")
    check(all(torch.equal(a, b) for (_, a), (_, b)
              in zip(flatten(got)[0], flatten(plain)[0])),
          f"collectives rank {rank}: the kernels' result is not bit-equal "
          "to the plain pack and unpack's")
    del plain
    dist.barrier()
    sync()
    t0 = time.perf_counter()
    tree_map(lambda g: exact_mean(g), grads)
    sync()
    plain_wall = time.perf_counter() - t0
    del grads
    rel = {}
    if rank == 0:
        gens = [torch.Generator(device="cuda").manual_seed(seed + k)
                for k in range(world)]
        for (path, leaf), (_, sd) in zip(flatten(got)[0],
                                          replica_shapes(torch, run)[0]):
            acc = torch.zeros(sd.shape, dtype=torch.float64, device="cuda")
            for gen in gens:
                acc += torch.randn(sd.shape, generator=gen, device="cuda"
                                   ).double()
            want = acc / world
            rel[path] = float((leaf.double() - want).abs().max()
                              / (want.abs().max() + 1e-12))
            del acc, want
    digest = tree_sha256(torch, got)
    return {"wall_ms": wall * 1e3, "plain_allreduce_ms": plain_wall * 1e3,
            "wire": dict(st.__dict__), "launches": counts, "rel": rel,
            "sha256": digest}


def pipe_stages(torch, run, params, stages: int):
    """qwen's layer stack cut into ``stages`` balanced stages by
    ``split_stage_params``: the stage trees (views) and the stage function,
    ``make_stage_prefill``'s hidden-to-hidden step."""
    from repro_torch.serve.stages import (build_templates, make_stage_prefill,
                                          split_stage_params)
    nper = run.model.num_layers // len(run.model.block_pattern)
    tpl = build_templates(nper, stages)[stages]
    parts = [{"decoder": {"layers": p["decoder"]["layers"]}}
             for p in split_stage_params(params, run.model, tpl)]
    widths = {hi - lo for lo, hi in zip(tpl.bounds, tpl.bounds[1:])}
    check(len(widths) == 1, f"{nper} periods do not cut into {stages} "
                            "equal stages")
    step = make_stage_prefill(run, 0, widths.pop(), first=False, last=False)
    return parts, (lambda p, h: step(p, h)[0])


def pipe_inputs(torch, run, seed: int):
    """(M, 1, PIPE_APPLY_TOKENS, d_model) bf16 hidden states on the card
    from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(int(seed))
    return torch.randn((PIPE_APPLY_MICROBATCHES, 1, PIPE_APPLY_TOKENS,
                        run.model.d_model), generator=gen, device="cuda"
                       ).to(torch.bfloat16)


def pipe_sequential(torch, run, params, seed, stages: int):
    """Every microbatch through the stages one after another."""
    parts, fn = pipe_stages(torch, run, params, stages)
    x = pipe_inputs(torch, run, seed)
    with torch.no_grad():
        out = torch.empty_like(x)
        for m in range(x.shape[0]):
            h = x[m]
            for p in parts:
                h = fn(p, h)
            out[m] = h
    return out


def rank_pipeline(torch, ops, dist, run, rank, world, seed):
    """``pipeline_apply`` of qwen's stack cut into ``world`` stages, the
    stage params stacked on a leading dim: a first call, then the one
    timed and checked, with the launch counts set to 0 just before it."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime.pipeline import pipeline_apply
    from repro_torch.tree import tree_map
    sync = torch.cuda.synchronize
    params = build_model(run).init(seed=seed, device="cuda")
    parts, fn = pipe_stages(torch, run, params, world)
    stacked = tree_map(lambda *xs: torch.stack(xs), *parts)
    del params, parts
    x = pipe_inputs(torch, run, seed)
    walls = []
    for _ in range(2):      # the first call also loads libraries, warms up
        dist.barrier()
        ops.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = pipeline_apply(fn, stacked, x)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    return {"wall_ms": walls[1], "first_ms": walls[0], "launches": counts,
            "out": out.cpu().view(torch.int16).numpy().tobytes()}


def dist_rank(rank: int, world: int, init: str, seed: int, results):
    """One rank process (spawned): the collectives, then pipeline_apply,
    on a gloo world met through ``init``; puts (rank, phase results) or
    (rank, the traceback) on ``results``."""
    import traceback
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    run = make_run_config("qwen3-0.6b", "decode_32k", seed=seed)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = {"collectives": rank_collectives(torch, ops, dist, run, rank,
                                               world, seed)}
        release(torch)
        res["pipeline_apply"] = rank_pipeline(torch, ops, dist, run, rank,
                                              world, seed)
        dist.barrier()
        results.put((rank, res))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def start_ranks(world: int, seed: int) -> dict:
    """Start ``dist_rank`` in ``world`` spawned processes, beside the
    groups before ``run_distributed``; returns the job that
    ``finish_ranks`` reads and joins."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="dist_smoke_")
    init = f"file://{os.path.join(tmp, 'pg')}"
    # daemonic: ended with this process if a check fails before the finish
    procs = [ctx.Process(target=dist_rank, args=(r, world, init, seed,
                                                 results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return {"procs": procs, "results": results, "tmp": tmp,
            "t0": time.perf_counter()}


def finish_ranks(job) -> tuple:
    """(the results of ``start_ranks``'s processes in rank order, seconds
    from their start, seconds waited here). Every process is joined, or
    ended, before this returns."""
    import queue
    procs, results = job["procs"], job["results"]
    world = len(procs)
    t0 = time.perf_counter()
    got = {}
    try:
        deadline = time.perf_counter() + DIST_TIMEOUT_S
        while len(got) < world:
            try:
                rank, res = results.get(timeout=5.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                check(not dead, f"rank processes {dead} died")
                check(time.perf_counter() < deadline,
                      f"the ranks took over {DIST_TIMEOUT_S:.0f} s more")
                continue
            check(not isinstance(res, str), f"rank {rank} failed:\n{res}")
            got[rank] = res
        secs = time.perf_counter() - job["t0"]
        for p in procs:
            p.join(timeout=60)
            check(p.exitcode == 0, f"a rank process exited {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        shutil.rmtree(job["tmp"], ignore_errors=True)
    return ([got[r] for r in range(world)], secs,
            time.perf_counter() - t0)


def phase_collectives(ranks, card) -> dict:
    res = [r["collectives"] for r in ranks]
    check(len({r["sha256"] for r in res}) == 1,
          "collectives: the ranks' results differ")
    rel = res[0]["rel"]
    for path, err in rel.items():
        bound = DIST_EXACT_BOUND if path == "['tiny']" else DIST_BOUND
        check(err < bound, f"collectives {path}: relative error {err:.3g} "
                           f"against the fp64 mean, bound {bound:.3g}")
    wire = res[0]["wire"]
    out = {"wall_ms": [r["wall_ms"] for r in res],
           "plain_allreduce_ms": [r["plain_allreduce_ms"] for r in res],
           "wire": wire, "max_rel_err": max(rel.values()),
           "leaves": len(rel), "sha256": res[0]["sha256"]}
    log(f"collectives: {DIST_RANKS} gloo ranks on the card, the "
        f"{len(rel) - 1} param leaves + 1 exact leaf, block {DIST_BLOCK} | "
        f"wall {max(out['wall_ms']):.1f} ms (plain fp32 all-reduce mean "
        f"{max(out['plain_allreduce_ms']):.1f} ms) | wire "
        f"{wire['wire_bytes'] / 1e9:.4f} GB a rank vs plain fp32 "
        f"{wire['plain_fp32_bytes'] / 1e9:.4f} GB "
        f"({wire['wire_bytes'] / wire['plain_fp32_bytes']:.3f}x) | max "
        f"rel err "
        f"{out['max_rel_err']:.3g} (bound {DIST_BOUND:.3g}) | ranks "
        f"bit-equal, bit-equal to the plain pack/unpack | launches a rank "
        f"{json.dumps([r['launches']['qdma_pack'] for r in res])} pack, "
        f"{json.dumps([r['launches']['qdma_unpack'] for r in res])} unpack "
        f"| {card}")
    return out


def phase_pipeline_apply(torch, run, ranks, ref, card) -> dict:
    from repro_torch.runtime.pipeline import bubble_fraction
    res = [r["pipeline_apply"] for r in ranks]
    want = ref.cpu().view(torch.int16).numpy().tobytes()
    for i, r in enumerate(res):
        check(r["out"] == want, f"pipeline_apply rank {i}: the output is "
                                "not bit-equal to the sequential stages")
    bubble = bubble_fraction(PIPE_APPLY_MICROBATCHES, DIST_RANKS)
    out = {"wall_ms": [r["wall_ms"] for r in res],
           "first_ms": [r["first_ms"] for r in res], "bubble": bubble,
           "launches": [r["launches"] for r in res]}
    layers = run.model.num_layers
    log(f"pipeline_apply: {run.model.name}'s {layers} layers as {DIST_RANKS}"
        f" gloo stages of {layers // DIST_RANKS} on the card, "
        f"M={PIPE_APPLY_MICROBATCHES} x (1, {PIPE_APPLY_TOKENS}, "
        f"{run.model.d_model}) bf16 | wall "
        f"{max(out['wall_ms']):.1f} ms (first call "
        f"{max(out['first_ms']):.1f} ms) | bubble {bubble:.4f} (3/11) | "
        f"every rank bit-equal to the sequential stages | flash_attention "
        f"launches a rank {json.dumps([c['flash_attention'] for c in out['launches']])}"
        f" | {card}")
    return out


EXAMPLES = (("quickstart", []), ("serve_batched", []),
            ("train_100m", ["--steps", "20"]))
#: the fourth example: eight ranks of its own, run as its command beside
#: the serve plane and pipeline groups (``start_elastic_example``)
ELASTIC_EXAMPLE = "elastic_reconf"
EXAMPLE_TIMEOUT_S = 600.0


def phase_examples(torch, ops, card, report, launches):
    """Three of the port's examples in this process through ``main``, their
    output to the log; the launch counts set to 0 just before each."""
    import contextlib
    import importlib
    import io
    report.setdefault("examples", {})
    for name, argv in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        workdir = tempfile.mkdtemp(prefix=f"{name}_smoke_")
        extra = ["--workdir", workdir] if name == "train_100m" else []
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main(argv + extra + ["--device", "cuda"])
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        for line in buf.getvalue().splitlines():
            log(f"  {name}: {line}")
        log(f"example {name}: {secs:.1f} s | launches "
            f"{json.dumps({k: n for k, n in counts.items() if n})} | {card}")
        report["examples"][name] = {"s": secs, "launches": counts}
        release(torch)
    check(report["examples"]["serve_batched"]["launches"]["flash_attention"]
          > 0, "flash_attention was never launched by serve_batched")


def start_elastic_example() -> dict:
    """``python -m repro_torch.examples.elastic_reconf --device cuda``, the
    user's command, started beside the serve plane and pipeline groups: its
    ``RankPool`` of eight worker processes runs no kernel of the port in
    this process."""
    return start_command([([sys.executable, "-m",
                            f"repro_torch.examples.{ELASTIC_EXAMPLE}",
                            "--device", "cuda"], {})],
                         f"example {ELASTIC_EXAMPLE}")


def finish_elastic_example(job, card, report):
    """The elastic example's output to the log, once it has exited 0."""
    (out,), secs, waited = finish_command(job, EXAMPLE_TIMEOUT_S)
    for line in out.splitlines():
        log(f"  {ELASTIC_EXAMPLE}: {line}")
    log(f"example {ELASTIC_EXAMPLE}: {secs:.1f} s as its own command beside "
        f"the serve plane and pipeline groups, waited {waited:.1f} s for it "
        f"here | {card}")
    report.setdefault("examples", {})[ELASTIC_EXAMPLE] = {
        "s": secs, "waited_s": waited}


def run_distributed(torch, ops, args, card, report, launches, params,
                    job):
    """The distributed runtime on the card: ``DIST_RANKS`` spawned ranks
    under gloo (NCCL refuses several ranks on one device), started by
    ``start_ranks`` beside the federation group (``job``), run the
    compressed gradient all-reduce on qwen3-0.6b-shaped replicas and
    ``pipeline_apply`` over qwen's 28 layers; then three of the examples
    (the fourth runs beside the serve plane and pipeline groups). The
    ranks' launch
    counts go into ``launches``."""
    from repro_torch.configs import make_run_config
    run = make_run_config("qwen3-0.6b", "decode_32k", seed=args.seed)
    t_group = time.perf_counter()
    ref = pipe_sequential(torch, run, params, args.seed, DIST_RANKS)
    ref = ref.cpu()
    release(torch)
    ranks, secs, waited = finish_ranks(job)
    report["distributed"] = {"ranks_s": secs, "waited_s": waited}
    for phase, need in DIST_KERNELS.items():
        for i, r in enumerate(ranks):
            counts = r[phase]["launches"]
            for k in need:
                check(counts[k] > 0, f"{k} was never launched on rank {i}'s "
                                     f"{phase} path")
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
    report["distributed"]["collectives"] = phase_collectives(ranks, card)
    report["distributed"]["pipeline_apply"] = phase_pipeline_apply(
        torch, run, ranks, ref, card)
    del ranks, ref
    phase_examples(torch, ops, card, report, launches)
    report["distributed"]["group_s"] = time.perf_counter() - t_group
    log(f"distributed group: {report['distributed']['group_s']:.1f} s "
        f"(ranks {report['distributed']['ranks_s']:.1f} s from their start "
        f"beside the federation group, waited "
        f"{report['distributed']['waited_s']:.1f} s for them here)")


#: the dry-run's one-card cells, qwen3-0.6b at full width: (shape, batch,
#: the kernel its step must launch)
DRYRUN_CELLS = (("decode_32k", DECODE_32K[0], "flash_decode"),
                ("prefill_32k", PREFILL_32K[0], "flash_attention"),
                ("train_4k", 2, None))
DRYRUN_WARM, DRYRUN_STEPS = 2, 5


def dryrun_step(torch, run, params, seed: int):
    """The step of a cell of ``run`` on the card, as a closure that holds
    its inputs: decode over a random bf16 cache at pos S - 1, prefill of
    random tokens, or a train step of AdamW on a copy of ``params``."""
    from repro_torch.models.model import build_model
    from repro_torch.train.optim import build_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_map
    model = build_model(run)
    B, S = run.shape.global_batch, run.shape.seq_len
    V = run.model.vocab_size
    g = torch.Generator(device="cuda").manual_seed(seed)
    if run.shape.kind == "decode":
        cache = tree_map(lambda s: torch.randn(
            s.shape, generator=g, device="cuda", dtype=s.dtype),
            model.cache_specs())
        tokens = torch.randint(0, V, (B, 1), generator=g, device="cuda",
                               dtype=torch.int32)
        return lambda: model.decode_step(params, cache, tokens, S - 1)[0]
    tokens = torch.randint(0, V, (B, S), generator=g, device="cuda",
                           dtype=torch.int32)
    if run.shape.kind == "prefill":
        return lambda: model.prefill(params, {"tokens": tokens})[1]
    state = {"params": tree_map(torch.clone, params)}
    state["opt"] = build_optimizer(run.optimizer).init(state["params"])
    state["step"] = torch.zeros((), dtype=torch.int32, device="cuda")
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    step = make_train_step(run)

    def train():
        new, metrics = step(state, batch)
        state.update(new)
        return metrics["loss"]
    return train


def run_dryrun(torch, ops, args, card, report, launches, params):
    """The dry-run against the card: each ``DRYRUN_CELLS`` cell counted on
    the unit mesh by the port's ``run_cell`` (the kernel path, NVLink
    ``Peaks``), then run for real with ``params`` (qwen3-0.6b at full
    width, fp32): the median of ``DRYRUN_STEPS`` steps after
    ``DRYRUN_WARM``, by CUDA events, and the peak memory of those steps.
    A step faster than its bound, or a peak below the counted argument
    bytes, means the count is wrong: both fail the script."""
    from repro_torch.configs import make_run_config
    from repro_torch.configs.base import SHAPES, UNIT_MESH, ShardingConfig
    from repro_torch.launch.dryrun import run_cell
    t_group = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out", "dryrun_torch")
    report["dryrun"] = {}
    for name, B, kernel in DRYRUN_CELLS:
        shape = dataclasses.replace(SHAPES[name], global_batch=B)
        t0 = time.perf_counter()
        cell = run_cell("qwen3-0.6b", name, False, out_dir=out_dir,
                        force=True, tag=f"b{B}", shape=shape,
                        mesh=UNIT_MESH, overrides={"kernel_backend": "auto"})
        count_s = time.perf_counter() - t0
        check(cell["status"] == "ok", f"dry-run {name} B={B}: "
                                      f"{cell.get('error')}")
        rf = cell["roofline"]
        run = make_run_config("qwen3-0.6b", shape, seed=args.seed,
                              sharding=ShardingConfig(remat="full"))
        fn = dryrun_step(torch, run, params, args.seed)
        ops.reset_launch_counts()
        times = []
        for i in range(DRYRUN_WARM + DRYRUN_STEPS):
            if i == DRYRUN_WARM:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()   # live before a step
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            if i >= DRYRUN_WARM:
                times.append(start.elapsed_time(end))
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(out).all()),
              f"dry-run {name} B={B}: non-finite output")
        # the count's kernel path against the card's: each kernel launched
        # as often as the count called it a step, the cell's own kernel
        # once a layer
        per_step = cell["cost_extrapolated"]["kernels"]
        if kernel:
            check(per_step.get(kernel) == run.model.num_layers,
                  f"dry-run {name}: the count called {kernel} "
                  f"{per_step.get(kernel)} times a step, not once a layer")
        for k, n in counts.items():
            want = (DRYRUN_WARM + DRYRUN_STEPS) * per_step.get(k, 0)
            check(n == want, f"dry-run {name} B={B}: {k} launched {n} times,"
                             f" the count says {want}")
            launches[k] += n
        ms = float(np.median(times))
        bound_ms = rf["step_s"] * 1e3
        arg = cell["memory"]["argument_bytes"]
        row = {"batch": B, "step_ms_median": ms, "step_ms": times,
               "bound_ms": bound_ms, "bound": rf["bound"],
               "ratio_to_bound": ms / bound_ms, "peak_bytes": peak,
               "argument_bytes": arg, "flops": rf["hlo_flops_per_dev"],
               "bytes": rf["hlo_bytes_per_dev"], "count_s": count_s,
               "temp_bytes": cell["memory"]["temp_bytes"],
               "step_peak_bytes": peak - base, "launches": counts}
        report["dryrun"][name] = row
        log(f"dry-run qwen3-0.6b {name} B={B}: step {ms:.2f} ms (median of "
            f"{DRYRUN_STEPS}) | bound {bound_ms:.2f} ms ({rf['bound']}; "
            f"{rf['hlo_flops_per_dev']:.4g} flops, "
            f"{rf['hlo_bytes_per_dev']:.4g} bytes) | ratio {ms / bound_ms:.3f}"
            f" | peak {peak / 1e9:.3f} GB, arguments {arg / 1e9:.3f} GB, "
            f"eager temp {cell['memory']['temp_bytes'] / 1e9:.3f} GB, the "
            f"step's peak above what was live {(peak - base) / 1e9:.3f} GB"
            f" | count {count_s:.1f} s | {card}")
        check(ms >= bound_ms, f"dry-run {name} B={B}: the step ({ms:.3f} ms)"
                              f" beats its bound ({bound_ms:.3f} ms): the "
                              "count is wrong")
        check(peak >= arg, f"dry-run {name} B={B}: peak memory {peak} below"
                           f" the counted argument bytes {arg}")
        del fn, out
        release(torch)
    report["dryrun"]["group_s"] = time.perf_counter() - t_group
    log(f"dry-run group: {report['dryrun']['group_s']:.1f} s")


# ---------------------------------------------------------------------------
# fp32 compute: qwen3-0.6b at compute="float32" through the attention
# kernels' fp32 paths
# ---------------------------------------------------------------------------
FP32_TOL = 2e-5          # the fp32 attention kernels vs their plain
                         # versions, elementwise atol = rtol: JAX's fp32
                         # kernel tolerance (tests/test_kernels.py:21)
FP32_LOGITS_TOL = 1e-3   # qwen's fp32 prefill logits and the generate
                         # path's, kernel path vs plain path, of max |logit|
                         # (the bf16 limit is LOGITS_REL_TOL, 1.5e-2)
FP32_LOSS_RTOL = 1e-5    # the eval step's loss at fp32 vs the plain loss
FP32_DECODE_SHARE = 0.25  # the fp32 decode kernels' largest share of the
                          # FP32_TOL limit (the paged ones at the serve pool,
                          # flash_decode at qwen's heads): their tensor-core
                          # pieces hold fp32 with a margin (0.009-0.027
                          # emulated, tests/test_torch_fp32.py)
FP32_KERNELS = ("flash_attention", "flash_decode", "paged_decode",
                "paged_decode_quant")
#: the device's names for the fp32 paths' tensor-core kernels:
#: flash_attention's, the paged decode's over fp32 pages (3xTF32) and over
#: int8 pages under fp32 q (three bf16 pieces of q and P), flash_decode's
#: (3xTF32)
FP32_ATTN_KERNEL = "flash_attention_tf32x3_kernel"
FP32_PAGED_KERNEL = "paged_decode_tf32x3_kernel"
FP32_QUANT_KERNEL = "paged_decode_bf16x3_kernel"
FP32_DECODE_KERNEL = "flash_decode_tf32x3_kernel"


def fp32_attention_shapes(cfg, families) -> list:
    """fp32 flash_attention's timed shapes, (S, H, K, hd, who): qwen's S
    384 and 600 (``cfg``), phi3-mini's hd 96 at 384 and internvl2's G 7
    at 640 (``families``); causal, S = T."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = [(384, H, K, hd, None), (600, H, K, hd, None)]
    return shapes + [(S, h, k, d, who) for S, T, h, k, d, causal, who
                     in families
                     if (who, S) in (("phi3-mini", 384),
                                     ("internvl2, 256 patches + 384", 640))]


def fp32_kernel_rows(torch, ops, timer, cfg, families) -> dict:
    """The four attention kernels on fp32 inputs against their plain
    versions on the card, timed: flash_attention at
    ``fp32_attention_shapes``; flash_decode at q (8,1,16,128) over
    (8,1024,8,128), int pos 511 and 1023; both paged kernels at the paged
    phase's pool and positions (fp32 pages; int8 pages under fp32 q);
    the decodes within FP32_DECODE_SHARE of the limit. Bound: bytes at
    3.35 TB/s or the products at the rate each kernel runs them, the
    larger: flash_attention's, flash_decode's and the paged decode's over
    fp32 pages as 3xTF32 on the tensor cores (FP32_ATTN_FLOP_PER_S), the
    paged decode's over int8 pages as three bf16 products on the tensor
    cores (FP32_QUANT_FLOP_PER_S). Library: SDPA at fp32 (tf32 off) for
    the dense kernels."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(28)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    rows = {k: [] for k in FP32_KERNELS}

    def row(name, label, fn, plain, nbytes, flops, lib, rate, most=1.0):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err, share = attn_err(got, want, FP32_TOL, FP32_TOL)
        check(got.dtype == torch.float32 and share <= most,
              f"{name} fp32 {label}: max_abs_err {err}, {share:.3g} of the "
              "limit")
        check(torch.equal(got, fn()), f"{name} fp32 {label}: not "
                                      "deterministic")
        ms, plain_ms = timer.ms(fn), timer.ms(plain)
        lib_ms = timer.ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops, rate)
        rows[name].append({"shape": f"{label} fp32", "max_abs_err": err,
                           "share_of_limit": share, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "library_ms": lib_ms})
        log(f"{name} fp32 {label}: max_abs_err {err:.3g} ({share:.3g} of the"
            f" limit) | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
            + (f"sdpa {lib_ms:.4f} ms | " if lib is not None else "")
            + f"bound {b_ms:.4f} ms ({b_by})")

    for S, h, k, d, who in fp32_attention_shapes(cfg, families):
        q, kk, vv = randn(1, S, h, d), randn(1, S, k, d), randn(1, S, k, d)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kk, vv))
        row("flash_attention", f"q (1,{S},{h},{d}) k/v {k} heads, causal"
            + (f" ({who})" if who else ""),
            lambda: ops.flash_attention(q, kk, vv),
            lambda: ops.flash_attention(q, kk, vv, backend="ref"),
            4 * 2 * S * d * (h + k), 4 * h * d * S * (S + 1) / 2,
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True,
                                                   enable_gqa=True),
            FP32_ATTN_FLOP_PER_S)
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, T = 8, 1024
    q, kk, vv = randn(B, 1, H, hd), randn(B, T, K, hd), randn(B, T, K, hd)
    qt = q.transpose(1, 2).contiguous()
    for pos in (511, 1023):
        n = pos + 1
        kt, vt = (x[:, :n].transpose(1, 2).contiguous() for x in (kk, vv))
        row("flash_decode", f"q ({B},1,{H},{hd}), k/v ({B},{T},{K},{hd}), "
            f"int pos {pos}",
            lambda: ops.flash_decode(q, kk, vv, pos),
            lambda: ops.flash_decode(q, kk, vv, pos, backend="ref"),
            4 * (2 * B * n * K * hd + 2 * B * H * hd), 4 * B * H * hd * n,
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   enable_gqa=True),
            FP32_ATTN_FLOP_PER_S, most=FP32_DECODE_SHARE)
    for quant in (False, True):
        name = "paged_decode_quant" if quant else "paged_decode"
        fn = getattr(ops, name)
        a = paged_inputs(torch, H, K, hd, PAGED_POS, 12 + quant, quant,
                         dtype=torch.float32)
        nbytes, flops = paged_work(a[0], a[1], a[-2], a[-1], quant)
        row(name, f"q {tuple(a[0].shape)}, pages (513,16,{K},{hd}) "
            f"{'int8' if quant else 'fp32'}, NP=64, pos {list(PAGED_POS)}",
            lambda: fn(*a), lambda: fn(*a, backend="ref"), nbytes, flops,
            lib=None,
            rate=FP32_QUANT_FLOP_PER_S if quant else FP32_ATTN_FLOP_PER_S,
            most=FP32_DECODE_SHARE)
    return rows


def plain_streams(torch, ops, run, params, kv_dtype, seed):
    """The 16 requests through the paged engine of ``run`` with host
    sampling: (token streams, the logits row each token was sampled
    from, by (rid, token index))."""
    from repro_torch.serve.engine import ServeEngine
    rows = {}

    def engine():
        eng = ServeEngine(run, params, device="cuda", slots=8, max_len=1024,
                          paged=True, page_size=16, kv_dtype=kv_dtype,
                          fused_sampling=False)
        sample = eng._sample

        def capture(req, row):
            rows[req.rid, len(req.out)] = np.array(row, np.float32)
            return sample(req, row)
        eng._sample = capture
        return eng
    out, _, _ = serve(torch, ops, run, params, kv_dtype, seed, engine=engine)
    return out, rows


def stream_gaps(requests, got, want, rows, vocab: int) -> list:
    """For each request whose stream ``got`` leaves ``want``: the first
    token j that differs and how near a tie it was where ``want``
    sampled token j, as the host sampler scores the logits row it drew
    from (``rows``): the least rise of the got token's logit that would
    make the sampler pick it, relative to max |logit|. Greedy: the
    logits' gap. Sampled (scores logit / temperature + the request's
    noise for token j, over the top-k): the got token's score must also
    clear the top-k threshold (``where`` says which bound it)."""
    from repro_torch.kernels.sampling import host_gumbel
    out = []
    for r, a, b in zip(requests, got, want):
        if a == b:
            continue
        j = first_difference(a, b)
        lg = rows[r.rid, j][:vocab].astype(np.float64)
        ta, tb = a[j], b[j]
        need, where = lg[tb] - lg[ta], "argmax"
        if r.temperature > 0:
            t = float(np.float32(r.temperature))
            z = lg / t
            g = host_gumbel(r.seed, r.rid, j, vocab).astype(np.float64)
            need = (z[tb] + g[tb]) - (z[ta] + g[ta])
            if 0 < r.top_k < vocab:
                kth = np.partition(z, -r.top_k)[-r.top_k]
                if kth - z[ta] > need:
                    need, where = kth - z[ta], "top-k"
            need *= t
        out.append({"rid": r.rid, "token": j, "got": ta, "want": tb,
                    "where": where,
                    "gap_rel": float(max(need, 0.0) / np.abs(lg).max())})
    return out


def fp32_generate(torch, ops, run, params, seed) -> dict:
    """``make_serve_steps``' generate path at fp32 compute, B = 4: prefill
    384 tokens, widen the cache to a dense one of 1,024 positions, then 31
    teacher-forced decode steps at one position for the batch (32 new
    tokens' logits), through the kernels (flash_attention, flash_decode)
    and through the plain versions; returns the distance of max |logit|,
    the kernel path's launches and the device's names for one decode
    step's flash_decode launches (``device_kernels``, outside the count:
    the last step again, which writes the same cache row)."""
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_serve_steps
    B, S0, new, T = 4, 384, 32, 1024
    rng = np.random.default_rng(seed + 300)
    toks = torch.tensor(rng.integers(0, run.model.vocab_size, (B, S0 + new)),
                        device="cuda")
    logits, counts, names = {}, None, None
    for path, r in (("kernel", run),
                    ("plain", run.replace(kernel_backend="reference"))):
        model = build_model(r)
        cparams = model.compute_params(params)
        prefill, decode = make_serve_steps(r)
        before = ops.launch_counts()
        with torch.no_grad():
            cache, last = prefill(cparams, {"tokens": toks[:, :S0]})
            dense = model.init_cache(dataclasses.replace(
                r.shape, seq_len=T, global_batch=B), device="cuda")
            for blk, node in cache.items():
                for name, leaf in node.items():
                    dense[blk][name][:, :, :S0] = leaf
            del cache
            out = [last]
            for t in range(S0, S0 + new - 1):
                lg, dense = decode(cparams, dense, toks[:, t:t + 1], t)
                out.append(lg)
        logits[path] = torch.stack(out).float()
        if path == "kernel":
            counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
            # the loop's last step again: it rewrites row ``last`` of the
            # cache with the same token, so the cache and logits stand
            last = S0 + new - 2
            with torch.no_grad():
                names = device_kernels(torch, [lambda: decode(
                    cparams, dense, toks[:, last:last + 1], last)])[0]
            names = [n for n in names if "flash_decode" in n]
        del dense, cparams, out
    a, b = logits["kernel"], logits["plain"]
    rel = float((a - b).abs().max() / b.abs().max())
    check(bool(torch.isfinite(a).all()), "fp32 generate: non-finite logits")
    return {"rel_err": rel, "steps": new, "launches": counts,
            "decode_step_flash_decode": names}


def decode_step_names(torch, found: dict):
    """A ``serve`` hook: at the first step with no request waiting (every
    request admitted, so the step decodes only), the device's names for
    one decode step's launches into ``found["names"]`` (``device_kernels``:
    a warm step, then the profiled one, both outside the loop's count)."""
    def hook(eng, steps):
        if "names" not in found and not eng.queue:
            found["names"] = device_kernels(torch, [eng.step])[0]
    return hook


def run_fp32(torch, ops, args, card, report, launches, params, kern):
    """qwen3-0.6b at full width under ``PrecisionConfig(compute="float32")``
    (fp32 params ``params``) through the attention kernels' fp32 paths:
    the four kernels' rows (``fp32_kernel_rows``, appended to ``kern``);
    then, with the counts set to 0, the prefill logits against the plain
    fp32 path (within FP32_LOGITS_TOL of max |logit|), and the device's
    names for one prefill's launches (each layer's attention
    FP32_ATTN_KERNEL, the 3xTF32 kernel); the serve traffic
    through the paged engine with fp32 pages, with int8 pages (fp32 q)
    and through the dense ring, each with fused == host sampling (I10),
    the device's names for one paged decode step's launches (one a layer,
    FP32_PAGED_KERNEL on fp32 pages, FP32_QUANT_KERNEL on int8 pages:
    the tensor-core kernels) and each stream equal to the plain engine's
    (reference kernels, the same KV layout; the dense ring against the
    plain fp32 pages), a
    stream that differs allowed only at a near tie (``stream_gaps``
    within FP32_LOGITS_TOL); the generate path within FP32_LOGITS_TOL of
    the plain path, one decode step's launches on the card one
    FP32_DECODE_KERNEL a layer; the eval step's loss within
    FP32_LOSS_RTOL of the plain loss. Each of the four kernels must have
    launched."""
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request
    from repro_torch.train.step import make_eval_step
    t_group = time.perf_counter()
    run = make_run_config_fp32(args.seed)
    cfg = run.model
    plain = run.replace(kernel_backend="reference")
    timer = Timer(torch)
    fam = family_attention_shapes(
        lambda arch: make_run_config_fp32(args.seed, arch).model)
    for name, rows in fp32_kernel_rows(torch, ops, timer, cfg, fam).items():
        kern[name].extend(rows)
    del timer
    release(torch)
    res = {"kernel_rows_s": time.perf_counter() - t_group}

    ops.reset_launch_counts()
    fast, slow = build_model(run), build_model(plain)
    rng = np.random.default_rng(args.seed + 100)
    worst = 0.0
    with torch.no_grad():
        for S in (200, 384):
            toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                                device="cuda")
            _, a = fast.prefill(params, {"tokens": toks})
            _, b = slow.prefill(params, {"tokens": toks})
            check(a.dtype == torch.float32 and a.shape == b.shape
                  and bool(torch.isfinite(a).all()),
                  f"fp32 prefill S={S}: non-finite or misshapen logits")
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
        # the device's names for one S=384 prefill's launches: its fp32
        # attention is the tensor-core kernel in every layer
        names, _ = device_kernels(
            torch, [lambda: fast.prefill(params, {"tokens": toks})])
    attn = [n for n in names if "flash_attention" in n]
    res["prefill_attention_kernels"] = sorted(set(attn))
    log(f"fp32 prefill S=384: {len(attn)} flash_attention launches on the "
        f"card, as {sorted(set(attn))}")
    check(len(attn) == cfg.num_layers
          and all(FP32_ATTN_KERNEL in n for n in attn),
          f"fp32 prefill: the card ran {attn}, not {cfg.num_layers} "
          f"launches of {FP32_ATTN_KERNEL}")
    del fast, slow, a, b
    res["prefill_logits_rel_err"] = worst
    log(f"fp32 prefill logits, kernel vs plain path (S=200, 384): max rel "
        f"err {worst:.3g} (tolerance {FP32_LOGITS_TOL})")
    check(worst <= FP32_LOGITS_TOL, f"fp32 prefill: kernel vs plain logits "
                                    f"differ by {worst:.3g} of max |logit|")

    reqs = make_requests(Request, cfg.vocab_size, args.seed)
    want = {kv: plain_streams(torch, ops, plain, params, kv, args.seed)
            for kv in (None, "int8")}
    res["serve"] = {}
    for label, kv, paged in (("fp32 pages", None, True),
                             ("int8 pages", "int8", True),
                             ("dense ring", None, False)):
        found = {}
        out, met, _ = serve(torch, ops, run, params, kv, args.seed,
                            paged=paged, hook=decode_step_names(torch, found)
                            if paged else None)
        host, _, _ = serve(torch, ops, run, params, kv, args.seed,
                           fused=False, paged=paged)
        check(host == out, f"fp32 serve {label}: host sampling gives other "
                           "tokens than fused sampling (I10)")
        if paged:
            want_name = FP32_QUANT_KERNEL if kv else FP32_PAGED_KERNEL
            names = [n for n in found.get("names", ())
                     if "paged_decode" in n]
            met["decode_step_paged_kernels"] = sorted(set(names))
            log(f"fp32 serve {label}: one decode step put {len(names)} "
                f"paged launches on the card, as {sorted(set(names))}")
            check(len(names) == cfg.num_layers
                  and all(want_name in n for n in names),
                  f"fp32 serve {label}: a decode step ran {names}, not "
                  f"{cfg.num_layers} launches of {want_name}")
        gaps = stream_gaps(reqs, out, *want[kv], cfg.vocab_size)
        met["streams_equal_plain"] = len(reqs) - len(gaps)
        met["diverged"] = gaps
        res["serve"][label] = met
        log(f"fp32 serve qwen3-0.6b {label}: 16 requests x 32 tokens in "
            f"{met['steps']} steps, {met['wall_s']:.2f} s | decode step "
            f"median {met['decode_step_ms_median']:.2f} ms | fused == host "
            f"sampling | streams equal to the plain engine's: "
            f"{len(reqs) - len(gaps)} of {len(reqs)}" + "".join(
                f"; rid {d['rid']} first differs at token {d['token']} "
                f"({d['got']} vs {d['want']}, {d['where']} gap "
                f"{d['gap_rel']:.3g} of max |logit|)" for d in gaps)
            + f" | {card}")
        for d in gaps:
            check(d["gap_rel"] <= FP32_LOGITS_TOL,
                  f"fp32 serve {label}: rid {d['rid']} leaves the plain "
                  f"engine's stream at token {d['token']} ({d['got']} vs "
                  f"{d['want']}) where the sampler's scores differ by "
                  f"{d['gap_rel']:.3g} of max |logit|: not a near tie")
    del want
    release(torch)

    gen = fp32_generate(torch, ops, run, params, args.seed)
    res["generate"] = gen
    gl = {k: gen["launches"][k] for k in ("flash_attention", "flash_decode")}
    log(f"fp32 generate B=4 prefill 384 + 31 decode steps: max rel err vs "
        f"the plain path {gen['rel_err']:.3g} (tolerance {FP32_LOGITS_TOL})"
        f" | launches {json.dumps(gl)}")
    check(gen["rel_err"] <= FP32_LOGITS_TOL,
          f"fp32 generate: kernel vs plain logits differ by "
          f"{gen['rel_err']:.3g} of max |logit|")
    check(gen["launches"]["flash_decode"] == (gen["steps"] - 1)
          * cfg.num_layers, "fp32 generate: flash_decode not launched once "
                            "a layer a step")
    names = gen["decode_step_flash_decode"]
    log(f"fp32 generate: one decode step put {len(names)} flash_decode "
        f"launches on the card, as {sorted(set(names))}")
    check(len(names) == cfg.num_layers
          and all(FP32_DECODE_KERNEL in n for n in names),
          f"fp32 generate: a decode step ran {names}, not {cfg.num_layers} "
          f"launches of {FP32_DECODE_KERNEL}")

    batch = train_batch(torch, run, 2000 + args.seed)
    ev = make_eval_step(run)(params, batch)
    with torch.no_grad():
        _, pm = build_model(plain).loss(params, batch)
    rel = abs(float(ev["loss"]) - float(pm["loss"])) / abs(float(pm["loss"]))
    res["eval"] = {"loss": float(ev["loss"]), "loss_plain": float(pm["loss"]),
                   "rel_diff": rel}
    log(f"fp32 eval step: loss {float(ev['loss']):.7f} vs the plain "
        f"{float(pm['loss']):.7f} (rel {rel:.3g}, tolerance "
        f"{FP32_LOSS_RTOL})")
    check(rel <= FP32_LOSS_RTOL, f"fp32 eval step: loss {float(ev['loss'])} "
                                 f"vs the plain {float(pm['loss'])}")
    del batch, ev, pm
    counts = ops.launch_counts()
    for k in FP32_KERNELS:
        check(counts[k] > 0, f"{k} was never launched on fp32 inputs on the "
                             "fp32 path")
    for k, n in counts.items():
        launches[k] += n
    res["launches"] = counts
    res["group_s"] = time.perf_counter() - t_group
    report["fp32"] = res
    log(f"fp32 group: {res['group_s']:.1f} s | launches "
        f"{json.dumps({k: counts[k] for k in FP32_KERNELS})} | {card}")
    release(torch)


def make_run_config_fp32(seed: int, arch: str = "qwen3-0.6b"):
    """``arch``'s full config at fp32 compute (fp32 params, as the port
    inits them)."""
    from repro_torch.configs import PrecisionConfig, make_run_config
    return make_run_config(arch, "decode_32k", seed=seed,
                           precision=PrecisionConfig(compute="float32"))


def run_hybrid(torch, ops, args, card, report, launches):
    """The hybrid stack's phases at full width: its prefill, its serve
    path (bf16 and int8 KV) and its generate path (its kernels,
    ``ssm_scan`` and ``flash_decode``, are checked with the other kernel
    phases). Fills ``report``, and adds each path's launch counts to
    ``launches``."""
    from repro_torch.configs import make_run_config
    from repro_torch.models.model import build_model
    hrun = make_run_config(HYBRID, "decode_32k", seed=args.seed)
    hcfg = hrun.model
    t0 = time.perf_counter()
    params = build_model(hrun).init(seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"{HYBRID} params: {hcfg.param_count():,} bf16 on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    report["hybrid_prefill"] = phase_family_prefill(
        torch, ops, hrun, params, args.seed, (100, 384), states=True,
        floor=0.0)
    report["hybrid_serve"] = {}
    hybrid_launches = dict.fromkeys(HYBRID_SERVE_KERNELS, 0)
    for kv in (None, "int8"):
        name = kv or "bf16"
        out, met, counts = serve(torch, ops, hrun, params, kv, args.seed,
                                 count=True, requests=hybrid_requests)
        for k in HYBRID_SERVE_KERNELS:
            hybrid_launches[k] += counts[k]
        host, _, _ = serve(torch, ops, hrun, params, kv, args.seed,
                           fused=False, requests=hybrid_requests)
        check(host == out, f"hybrid serve kv={name}: host sampling gives "
                           "other tokens than fused sampling (I10)")
        what = "fused == host sampling"
        if kv is None:
            paused, _, _ = serve(torch, ops, hrun, params, kv, args.seed,
                                 pause_at=10, requests=hybrid_requests)
            check(paused == out, f"hybrid serve kv={name}: the pause round "
                                 "trip changed the tokens (I10)")
            what += ", pause round trip token-identical"
        met["launches"] = counts
        report["hybrid_serve"][name] = met
        log(f"serve {HYBRID} kv={name}: 16 requests x 32 tokens in "
            f"{met['steps']} steps, {met['wall_s']:.2f} s | decode step "
            f"median {met['decode_step_ms_median']:.2f} ms | "
            f"{met['tokens_per_s']:.1f} tokens/s | {card} | {what} | "
            f"launches {json.dumps(counts)}")
    for k in HYBRID_SERVE_KERNELS:
        check(hybrid_launches[k] > 0,
              f"{k} was never launched on the hybrid serve path")
    report["generate"] = phase_generate(torch, ops, hrun, params, args.seed)
    for k in HYBRID_SERVE_KERNELS:
        launches[k] = launches.get(k, 0) + hybrid_launches[k]
    for k in GENERATE_KERNELS:
        launches[k] = launches.get(k, 0) + report["generate"]["launches"][k]
    if args.profile:
        report["profile_hybrid"] = phase_profile(
            torch, hrun, params, args.seed, name="hybrid_decode",
            requests=hybrid_requests)
    del params
    release(torch)


# ---------------------------------------------------------------------------
# training: launch.train, the train Tenant under the manager, eval
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_LR = "1e-4"        # AdamW moves an entry by about lr a step; the
                         # largest-fan-in leaf, the tied embedding, starts
                         # at std 1/sqrt(151936) = 2.6e-3, which lr 3e-3
                         # and 1e-3 overwrite within a few steps (the loss
                         # rises over ln V; the readings are in PERF.md)
CE_BAND = 0.45           # the first ce within this share of ln V of ln V
                         # (random init: tests/test_models.py's bound)
CE_ABS_TOL = 1e-2        # the eval step's ce (flash_attention) vs the plain
                         # path's, absolute: both sum the same bf16 stack,
                         # the kernel and the plain version round their fp32
                         # attention to bf16 after sums in other orders


def train_batch(torch, run, step: int) -> dict:
    """The synthetic batch of ``step`` (TRAIN_BATCH x TRAIN_SEQ) on the
    card."""
    from repro_torch.data.pipeline import SyntheticSource, to_device
    src = SyntheticSource(run, batch_override=TRAIN_BATCH,
                          seq_override=TRAIN_SEQ)
    return to_device(src.batch_at(step), "cuda")


def phase_train_launch(torch, workdir, card, lr: str = TRAIN_LR):
    """``repro_torch.launch.train`` called as a function: qwen3-0.6b at
    full width (fp32 params, bf16 compute, AdamW, remat per layer), 30
    steps of batch 4 x 512 at lr 3e-3 with 5 warmup steps, one final
    checkpoint. Every loss finite, the first ce near ln V, and the mean
    loss of the last five steps below that of the first five."""
    import math
    from repro_torch.launch import train as launch
    wd = os.path.join(workdir, "train_launch")
    args = launch.parser().parse_args([
        "--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
        str(TRAIN_SEQ), "--steps", "30", "--lr", lr, "--warmup", "5",
        "--workdir", wd, "--checkpoint-every", "0", "--log-every", "10",
        "--device", "cuda"])
    t0 = time.perf_counter()
    last = launch.train(args)
    wall = time.perf_counter() - t0
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    shutil.rmtree(wd, ignore_errors=True)
    losses = [m["loss"] for m in lines]
    lnv = math.log(launch.build(args)[0].model.vocab_size)
    check(len(lines) == 30 and all(np.isfinite(losses)),
          f"train: {len(lines)} steps, losses {losses}")
    check(abs(lines[0]["ce"] - lnv) < CE_BAND * lnv,
          f"train: the first ce {lines[0]['ce']:.4f} is not within "
          f"{CE_BAND} ln V of ln V = {lnv:.4f}")
    first, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(tail < first, f"train: the last five steps' mean loss {tail:.4f} "
                        f"is not below the first five's {first:.4f}")
    step_s = float(np.median([m["step_s"] for m in lines[1:]]))
    res = {"steps": len(lines), "losses": losses,
           "grad_norms": [m["grad_norm"] for m in lines],
           "first_ce": lines[0]["ce"], "ln_v": lnv,
           "first5_mean": first, "last5_mean": tail,
           "first_step_s": lines[0]["step_s"], "step_s_median": step_s,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "wall_s": wall, "final": last}
    log(f"train {TRAIN_ARCH} full width, batch {TRAIN_BATCH} x {TRAIN_SEQ}, lr {lr}, "
        f"30 steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} (first five "
        f"{first:.4f}, last five {tail:.4f}), first ce {lines[0]['ce']:.4f} "
        f"(ln V {lnv:.4f}) | step median {step_s * 1e3:.1f} ms (first "
        f"{lines[0]['step_s'] * 1e3:.0f} ms) | "
        f"{res['tokens_per_s']:.0f} tokens/s | {wall:.1f} s with the init "
        f"and the final save | {card}")
    return res


def train_pool():
    """Four logical slots of the card."""
    from repro_torch.core import DevicePool
    return DevicePool([f"traindev{i}" for i in range(4)], max_vfs=4)


def train_tenant(run, tid: str, seed: int):
    from repro_torch.core import Tenant
    return Tenant(tid, run, local_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                  seed=seed, device="cuda")


def state_bytes(torch, state) -> int:
    """Device bytes of a state tree, each storage counted once."""
    from repro_torch.tree import tree_leaves
    seen = {}
    for t in tree_leaves(state):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def phase_train_tenant(torch, ops, run, seed, workdir, card):
    """The paper's transparency for a training guest at full width: two
    qwen3-0.6b train tenants from one seed, each under its own manager
    over four logical slots of the card. Tenant A runs 3 steps, is paused
    with the bit-exact staging engine (digest dirty tracking: a
    ``qdma_digest`` of every leaf of its state), unpaused, reconfigured
    through pause, and runs 3 more; B runs the same 6 steps undisturbed.
    The six losses and every leaf of the two final states must be
    bit-equal; the pause must free >= 90% of the state's device bytes and
    the unpause bring them back. Then one int8 pause of A (lossy by
    design): every leaf within its int8 bound, the staging kernels'
    device time from one profiler session. Two undisturbed tenants are
    already bit-equal without ``torch.use_deterministic_algorithms``
    (``tools/train_readings.py``), so the phase runs without it."""
    from repro_torch.core import SVFFManager, StagingEngine
    from repro_torch.tree import flatten
    mgr_b = SVFFManager(train_pool(), workdir=os.path.join(workdir, "b"))
    b = train_tenant(run, "trainB", seed)
    mgr_b.init(1, [b])
    lb = [b.run_steps(1)["loss"] for _ in range(6)]
    mgr_a = SVFFManager(train_pool(), workdir=os.path.join(workdir, "a"),
                        staging=StagingEngine(incremental=True,
                                              dirty="digest"))
    slog = StagingLog(mgr_a.staging)
    a = train_tenant(run, "trainA", seed)
    mgr_a.init(1, [a])
    la = [a.run_steps(1)["loss"] for _ in range(3)]
    nbytes = state_bytes(torch, a.export_state())
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    m0 = allocated(torch, dev)
    t = mgr_a.pause(a)
    m1 = allocated(torch, dev)
    tu = mgr_a.unpause(a)
    m2 = allocated(torch, dev)
    tr = mgr_a.reconf(1, use_pause=True)
    counts = ops.launch_counts()
    la += [a.run_steps(1)["loss"] for _ in range(3)]
    same = flatten(a.export_state())[0], flatten(b.export_state())[0]
    diff = [p for (p, x), (_, y) in zip(*same) if not bits_equal(torch, x, y)]
    res = {
        "losses_a": la, "losses_b": lb, "state_bytes": nbytes,
        "leaves_differing": diff, "launches": counts,
        "pause_ms": {k: v * 1e3 for k, v in t.phases.items()},
        "pause_stop_ms": t.stop_ms,
        "unpause_ms": {k: v * 1e3 for k, v in tu.phases.items()},
        "reconf_ms": {k: v * 1e3 for k, v in tr.items()},
        "save": transfer_row(slog.saves[:1]),
        "restore": transfer_row(slog.restores[:1]),
        "freed_bytes": m0 - m1, "back_bytes": m2 - m1}
    log(f"train tenant A (pause, unpause, reconf through pause) vs B "
        f"undisturbed: losses {'bit-equal' if la == lb else 'DIFFER'} "
        f"{la} | {len(diff)} of {len(same[0])} leaves differ | pause stop "
        f"{t.stop_ms:.1f} ms ({', '.join(f'{k} {v * 1e3:.1f}' for k, v in t.phases.items())}) "
        f"| save {res['save']['bytes_moved']:,} B at "
        f"{res['save']['gb_per_s']:.2f} GB/s | unpause {tu.total * 1e3:.1f} "
        f"ms, restore {res['restore']['gb_per_s']:.2f} GB/s | reconf "
        f"{tr['total'] * 1e3:.1f} ms | freed {m0 - m1:,} of {nbytes:,} "
        f"state bytes, {m2 - m1:,} back | qdma_digest launches "
        f"{counts['qdma_digest']} | {card}")
    check(la == lb, f"train tenant: the paused tenant's losses {la} differ "
                    f"from the undisturbed twin's {lb}")
    check(not diff, f"train tenant: {len(diff)} leaves differ from the twin's"
                    f" ({diff[:4]})")
    check(m0 - m1 >= 0.9 * nbytes, f"train pause freed {m0 - m1} of the "
                                   f"state's {nbytes} device bytes (< 90%)")
    check(m2 - m1 >= 0.9 * nbytes, f"train unpause brought back {m2 - m1} "
                                   f"of {nbytes} bytes")
    check(counts["qdma_digest"] > 0, "qdma_digest was never launched by the "
                                     "train pause")
    del b, mgr_b, same
    release(torch)

    # the int8 pause (lossy by design)
    eng8 = StagingEngine(compression="int8", block=QDMA_BLOCK,
                         incremental=True, dirty="digest", transport="stream")
    mgr_a.staging = eng8
    slog8 = StagingLog(eng8, keep=True)
    ops.reset_launch_counts()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t8 = mgr_a.pause(a)
        tu8 = mgr_a.unpause(a)
        torch.cuda.synchronize()
    counts8 = ops.launch_counts()
    exported, slog8.last_tree = slog8.last_tree, None
    share = int8_share(torch, exported, a.export_state(), eng8, "train int8")
    del exported
    kern_ms = {}
    for e in prof.key_averages():
        m = STAGING_KERNEL_NAMES.search(e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and m:
            kern_ms[m.group(1)] = (kern_ms.get(m.group(1), 0.0) + getattr(
                e, "self_device_time_total", 0.0) / 1e3)
    for k in ("qdma_pack_rows", "qdma_unpack", "qdma_digest"):
        check(counts8[k] > 0, f"{k} was never launched by the int8 train "
                              "pause")
    res["int8"] = {"stop_ms": t8.stop_ms, "unpause_ms": tu8.total * 1e3,
                   "save": transfer_row(slog8.saves),
                   "restore": transfer_row(slog8.restores),
                   "int8_bound_share": share, "launches": counts8,
                   "staging_kernel_device_ms": kern_ms}
    moved = res["int8"]["save"]
    log(f"train tenant int8 pause: stop {t8.stop_ms:.1f} ms, unpause "
        f"{tu8.total * 1e3:.1f} ms | moved {moved['bytes_moved']:,} of "
        f"{moved['logical_bytes']:,} logical bytes | int8 bound share "
        f"{share:.6g} | staging kernels' device time "
        + (", ".join(f"{k} {v:.2f} ms" for k, v in kern_ms.items())
           or "not recorded by the profiler")
        + f" | launches {json.dumps({k: counts8[k] for k in QDMA_KERNELS})}"
        f" | {card}")
    return res, a, mgr_a


def phase_train_eval(torch, ops, run, params, seed):
    """``make_eval_step`` on the card (no grad: the forward launches
    ``flash_attention``) against the train-mode loss through the plain
    attention (``kernel_backend="reference"``), on the same params and
    batch: logits within LOGITS_REL_TOL of max |logit|, ce within
    CE_ABS_TOL. Then the refusal: the kernel wrappers raise when asked to
    launch on inputs that require grad, and launch under no_grad."""
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_eval_step
    batch = train_batch(torch, run, 1000 + seed)
    plain_run = run.replace(kernel_backend="reference")
    ops.reset_launch_counts()
    ev = make_eval_step(run)(params, batch)
    counts = ops.launch_counts()
    with torch.no_grad():
        _, pm = build_model(plain_run).loss(params, batch)
        a = build_model(run).forward(params, batch)[0]
        b = build_model(plain_run).forward(params, batch)[0]
    rel = float((a - b).abs().max() / b.abs().max())
    del a, b
    dce = abs(float(ev["ce"]) - float(pm["ce"]))
    check(counts["flash_attention"] == run.model.num_layers,
          f"eval step: {counts['flash_attention']} flash_attention launches "
          f"for {run.model.num_layers} layers")
    check(rel <= LOGITS_REL_TOL, f"eval step: kernel vs plain logits differ "
                                 f"by {rel:.3g} of max |logit|")
    check(dce <= CE_ABS_TOL, f"eval step: ce {float(ev['ce'])} vs the plain "
                             f"path's {float(pm['ce'])}")
    g = torch.Generator(device="cuda").manual_seed(seed + 400)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(
            dtype).requires_grad_(True)
    hd = run.model.head_dim
    q, k, v = randn(1, 64, 16, hd), randn(1, 64, 8, hd), randn(1, 64, 8, hd)
    x, bv, cv = randn(1, 64, 4, 64), randn(1, 64, 64), randn(1, 64, 64)
    la = -randn(1, 64, 4, dtype=torch.float32).abs()
    refused = []
    for name, call in (
            ("flash_attention", lambda: ops.flash_attention(q, k, v)),
            ("ssm_scan", lambda: ops.ssm_scan(x, bv, cv, la, chunk=64))):
        try:
            call()
        except RuntimeError as e:
            refused.append(name if "no backward" in str(e) else str(e))
    check(refused == ["flash_attention", "ssm_scan"],
          f"the kernels under autograd: {refused} (each must refuse)")
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    res = {"flash_attention_launches": counts["flash_attention"],
           "logits_rel_err": rel, "ce_eval": float(ev["ce"]),
           "ce_plain": float(pm["ce"]), "ce_abs_diff": dce,
           "loss_eval": float(ev["loss"]), "loss_plain": float(pm["loss"]),
           "refused_under_autograd": refused}
    log(f"eval step through flash_attention ({counts['flash_attention']} "
        f"launches) vs the plain train-mode loss: logits max rel err "
        f"{rel:.3g} (tolerance {LOGITS_REL_TOL}), ce {res['ce_eval']:.5f} vs "
        f"{res['ce_plain']:.5f} (|diff| {dce:.3g}, tolerance {CE_ABS_TOL}) | "
        "flash_attention and ssm_scan refuse inputs that require grad")
    return res, counts


def phase_tables(card):
    """Paper Tables I and II on the card: 32 logical slots, one
    svff-bench train tenant per VF, ``reconf`` through detach/attach and
    through pause (Table I: 10 runs each at 1, 4 and 10 VFs)."""
    from repro_torch.bench import table1, table2
    rows1 = table1.bench(10, (1, 4, 10), device="cuda")
    rows2 = table2.bench((1, 4, 10), device="cuda")
    for r in rows1:
        log(f"Table I {r['num_vf']} VF: detach/attach "
            f"{r['detach_attach_ms']:.2f} ms (std "
            f"{r['detach_attach_std']:.2f}), pause/unpause "
            f"{r['pause_unpause_ms']:.2f} ms (std "
            f"{r['pause_unpause_std']:.2f}), overhead "
            f"{r['overhead_pct']:.1f}% | {card}")
    for r in rows2:
        log(f"Table II {r['num_vf']} VF: " + ", ".join(
            f"{s} DA {r[f'DA_{s}_ms']:.2f} / PU {r[f'PU_{s}_ms']:.2f}"
            for s in ("rescan", "remove_vf", "change_num_vf", "add_vf",
                      "total")) + f" ms | {card}")
    return {"table1": rows1, "table2": rows2}


def run_train(torch, ops, args, card, report, launches, workdir):
    """The training phases at full width, each path's launch counts added
    to ``launches``."""
    from repro_torch.configs import make_run_config
    report["train_launch"] = phase_train_launch(torch, workdir, card)
    release(torch)
    run = make_run_config(TRAIN_ARCH, "train_4k", seed=args.seed)
    res, a, mgr = phase_train_tenant(torch, ops, run, args.seed,
                                     os.path.join(workdir, "tenants"), card)
    for k in QDMA_KERNELS:
        launches[k] = (launches.get(k, 0) + res["launches"][k]
                       + res["int8"]["launches"][k])
    report["train_tenant"] = res
    report["train_eval"], counts = phase_train_eval(
        torch, ops, run, a.export_state()["params"], args.seed)
    launches["flash_attention"] = (launches.get("flash_attention", 0)
                                   + counts["flash_attention"])
    del a, mgr
    release(torch)
    report["tables"] = phase_tables(card)


# ---------------------------------------------------------------------------
# the train tenant sharded over its VF's mesh: a rank pool on the card
# ---------------------------------------------------------------------------
SPMD_RANKS = 4
SPMD_LAYERS = 4          # qwen3-0.6b at full width, 4 of its 28 layers: a
                         # 28-layer step on four gloo ranks of one card
                         # took 17-24 s (PERF.md), which would take this
                         # phase and the script past their limits
SPMD_LOSS_TOL = 1e-4     # a sharded step's loss (the eval loss, a step
                         # after the int8 reshard, launch.train's) vs the
                         # one-device run's, absolute on ~11.9, where a step
                         # moves it ~5e-3: bf16 compute, the ranks' partial
                         # sums in other orders (read: 1.53e-5, eval 9.5e-6,
                         # after int8 1.72e-5, launch.train 1.34e-5)
SPMD_GNORM_RTOL = 1e-3   # a sharded step's grad norm vs the twin's,
                         # relative (read: 1.41e-4; a gradient summed
                         # twice, or of half the batch, is off by tens of
                         # percent)
SPMD_TWIN_STEPS = 3      # the tenant's steps before the int8 reshard (2 on
                         # (2, 1), 1 on (2, 2)), each held against the
                         # one-device twin's; then one step after it
SPMD_LAUNCH_STEPS = 2    # launch.train's steps, 2 ranks against 1
SPMD_PARAM_SHARE = 0.1   # per param leaf after SPMD_TWIN_STEPS steps:
                         # |sharded - twin's| over |twin's - init| (L2):
                         # AdamW's update is
                         # about lr * sign(g), so a rounding difference
                         # where g is near zero turns that element's step
                         # (read: 0.021)
SPMD_MEM_SHARE = 0.05    # a rank's allocated bytes vs its blocks' bytes
SPMD_KERNELS = ("qdma_pack_rows", "qdma_unpack", "qdma_digest",
                "flash_attention")


def spmd_run(seed: int):
    """qwen3-0.6b's train config at full width, cut to SPMD_LAYERS."""
    from repro_torch.configs import make_run_config
    return cut_layers(make_run_config(TRAIN_ARCH, "train_4k", seed=seed))


def host_leaves(snap) -> dict:
    """{path: CPU tensor or QuantizedLeaf} of a staged tree."""
    from repro_torch.tree import flatten
    return {p: getattr(x, "leaf", x) for p, x in flatten(
        snap, is_leaf=lambda x: hasattr(x, "leaf"))[0]}


def spmd_tenant(torch, rp, run, seed, workdir, twin, card):
    """One train tenant on 2-rank VFs ((2, 1) meshes) of the rank pool: 2
    steps, a pause with plain staging, ``set_num_vfs(1,
    devices_per_vf=4)``, the unpause onto (2, 2), 1 step, one eval step
    through ``flash_attention`` on each rank's local heads; then a pause
    with int8 staging (packed and digested on the ranks), ``set_num_vfs(2,
    devices_per_vf=2)``, the unpause onto (2, 1) (unpacked there) and one
    step. The plain reshard bit-equal to the paused snapshot, the int8
    one within max|a|/64 of each leaf; every rank's allocated bytes
    (above what it held without the state) within SPMD_MEM_SHARE of its
    blocks' bytes on each mesh, below the whole state's."""
    from repro_torch.core import DevicePool, StagingEngine, SVFFManager
    from repro_torch.core import Tenant
    pool = DevicePool(rp.ranks)
    mgr = SVFFManager(pool, workdir=os.path.join(workdir, "spmd"))
    tn = Tenant("spmd", run, local_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                seed=seed, device="cuda")
    rp.reset_launch_counts()
    base = rp.memory()
    mgr.init(num_vfs=2, tenants=[tn], devices_per_vf=2)
    res = {"meshes": [list(pool.find(tn.vf_id).mesh_shape)],
           "rank_bytes": {}, "step_ms": {}}

    def held(label, base):
        """Each rank's allocated bytes above ``base`` (what it held
        without the state: cuBLAS's workspaces once it ran a step)."""
        st = tn.export_state()
        mem, want = st.memory(), st.shardings.local_bytes()
        for r, (local, alloc) in mem.items():
            check(local == want[r], f"spmd {label}: rank {r} holds {local} "
                                    f"B of blocks, the specs give {want[r]}")
            grew = alloc - base[r]
            check(abs(grew - want[r]) <= SPMD_MEM_SHARE * want[r]
                  and want[r] < twin["state_bytes"],
                  f"spmd {label}: rank {r} has {grew} B more allocated for "
                  f"{want[r]} B of blocks (state {twin['state_bytes']})")
        res["rank_bytes"][label] = {
            str(r): {"blocks": want[r], "allocated": mem[r][1] - base[r]}
            for r in mem}

    def steps(n, label):
        out = [tn.run_steps(1) for _ in range(n)]
        res["step_ms"].setdefault(label, []).extend(
            x * 1e3 for x in tn.step_times[-n:])
        return out

    def repartition(engine, vfs, per, label):
        """Pause through ``engine``, repartition, unpause onto ``per``
        ranks; returns (the snapshot's host leaves, pause ms, unpause
        ms)."""
        mgr.staging = engine
        tp = mgr.pause(tn)
        snap = host_leaves(mgr.snapshots[tn.tid].payload)
        pool.set_num_vfs(vfs, devices_per_vf=per)
        base = rp.memory()
        tu = mgr.unpause(tn, num_devices=per)
        res["meshes"].append(list(pool.find(tn.vf_id).mesh_shape))
        held(label, base)
        return snap, tp.total * 1e3, tu.total * 1e3

    held("(2, 1)", base)
    rp.traffic(reset=True)
    rp.comm_counts(True)
    ms = steps(2, "(2, 1)")
    res["comm_counts_a_step"] = rp.comm_counts(False)[0][-1]
    res["collective_bytes_2_steps"] = {
        str(i): t for i, t in enumerate(rp.traffic(reset=True)[:2])}
    snap, res["pause_ms"], res["unpause_ms"] = repartition(
        StagingEngine(), 1, 4, "(2, 2)")
    after = host_leaves(StagingEngine().save(tn.export_state()))
    diff = [p for p in snap if not bits_equal(torch, snap[p], after[p])]
    check(not diff, f"spmd plain: {len(diff)} leaves changed on the unpause "
                    f"onto (2, 2) ({diff[:3]})")
    res["leaves_changed_by_unpause"] = len(diff)
    del snap, after
    ms += steps(1, "(2, 2)")
    ev = tn.export_state().eval(twin["eval_batch"])
    after = host_leaves(StagingEngine().save(tn.export_state()))
    drift = param_drift(after, twin)
    _, res["int8_pause_ms"], res["int8_unpause_ms"] = repartition(
        StagingEngine(compression="int8", block=QDMA_BLOCK), 2, 2,
        "(2, 1) int8")
    back = host_leaves(StagingEngine().save(tn.export_state()))
    share = max(float((back[p].float() - a.float()).abs().max()
                      / max(float(a.float().abs().max()), 1e-30))
                for p, a in after.items() if a.numel())
    res["int8_max_rel_move"] = share
    del after, back
    ms += steps(1, "(2, 1) int8")
    counts = rp.launch_counts()
    tn.export_state().release()
    losses = [m["loss"] for m in ms]
    n = SPMD_TWIN_STEPS
    dl = max(abs(a - b) for a, b in zip(losses[:n], twin["losses"]))
    d8 = abs(losses[n] - twin["losses"][n])
    de = abs(ev["loss"] - twin["eval_loss"])
    dg = max(abs(m["grad_norm"] - g) / g
             for m, g in zip(ms[:n], twin["grad_norms"]))
    res.update(losses=losses, max_loss_diff=dl, int8_loss_diff=d8,
               eval_loss=ev["loss"], eval_loss_diff=de,
               grad_norm_rel_diff=dg, param_drift=drift, launches=counts)
    log(f"spmd tenant, qwen3-0.6b full width {SPMD_LAYERS} layers, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: step ms " + " | ".join(
            f"{k} {', '.join(f'{x:.0f}' for x in v)}"
            for k, v in res["step_ms"].items())
        + f" | plain pause {res['pause_ms']:.0f} ms, unpause "
        f"{res['unpause_ms']:.0f} ms; int8 pause {res['int8_pause_ms']:.0f}"
        f" ms, unpause {res['int8_unpause_ms']:.0f} ms (max rel move "
        f"{share:.3g}) | losses {losses} vs twin max diff {dl:.3g}, after "
        f"int8 {d8:.3g}, eval diff {de:.3g}, grad norms rel {dg:.3g}, "
        f"params after {n} steps {drift:.3g} of their move | rank bytes "
        f"{json.dumps(res['rank_bytes'])} | collectives rank 0, 2 steps "
        f"(calls, input bytes) "
        f"{json.dumps(res['collective_bytes_2_steps']['0'])} | CommDebugMode"
        f" a step {json.dumps(res['comm_counts_a_step'])} | launches "
        f"{json.dumps({k: counts[k] for k in SPMD_KERNELS})} | {card}")
    check(share <= 1 / 64, f"spmd int8: a leaf moved by {share:.3g} of its "
                           "max |a| (> 1/64)")
    check(res["meshes"] == [[2, 1], [2, 2], [2, 1]],
          f"spmd: meshes {res['meshes']}")
    check(all(np.isfinite(losses)) and dl <= SPMD_LOSS_TOL,
          f"spmd: losses {losses[:n]} vs the one-device twin's "
          f"{twin['losses'][:n]} (max diff {dl:.3g} > {SPMD_LOSS_TOL})")
    check(d8 <= SPMD_LOSS_TOL, f"spmd: the step after the int8 reshard "
                               f"{losses[n]} vs the twin's "
                               f"{twin['losses'][n]} (> {SPMD_LOSS_TOL})")
    check(de <= SPMD_LOSS_TOL, f"spmd: eval loss {ev['loss']} vs the twin's "
                               f"{twin['eval_loss']} (> {SPMD_LOSS_TOL})")
    check(dg <= SPMD_GNORM_RTOL,
          f"spmd: grad norms {[m['grad_norm'] for m in ms[:n]]} vs the "
          f"twin's {twin['grad_norms'][:n]} (> {SPMD_GNORM_RTOL} relative)")
    check(drift <= SPMD_PARAM_SHARE, f"spmd: after {n} steps a param leaf lies "
                                     f"{drift:.3g} of its move from the "
                                     f"twin's (> {SPMD_PARAM_SHARE})")
    for k in SPMD_KERNELS:
        check(counts[k] > 0, f"spmd: the ranks never launched {k}")
    return res


def spmd_attention_case(w, key, run, seed):
    """On one worker of the mesh ``key``: the model's ``attention`` of
    DTensor q, k, v laid out by the ``attn_q`` / ``attn_kv`` specs at the
    tenant's shapes (the kernel on this rank's local batch and heads),
    this rank's block of the output against the plain attention (the
    kernel's plain version, ``flash_attention_ref``) on this rank's
    blocks of q, k and v. Returns (the local q shape, max_abs_err, its
    share of the attention limit)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import MeshConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import attention
    from repro_torch.runtime.partitioning import (ShardingRules, local_shard,
                                                  placements, spmd_scope)
    mesh = w.mesh(key)
    shape, axes, _ = key
    rules = ShardingRules(MeshConfig(tuple(shape), tuple(axes)), run, mesh)
    cfg = run.model
    g = torch.Generator(device=w.device).manual_seed(seed)

    def make(heads, kind):
        full = torch.randn((TRAIN_BATCH, TRAIN_SEQ, heads, cfg.head_dim),
                           generator=g, device=w.device).to(torch.bfloat16)
        pl = placements(rules.spec(kind, tuple(full.shape)), axes)
        return DTensor.from_local(local_shard(full, mesh, pl), mesh, pl,
                                  run_check=False)
    q = make(cfg.num_heads, "attn_q")
    k, v = (make(cfg.num_kv_heads, "attn_kv") for _ in "kv")
    with spmd_scope(rules):
        got = attention(q, k, v, causal=True).to_local()
    want = kops.flash_attention(q.to_local(), k.to_local(), v.to_local(),
                                causal=True, backend="ref")
    err, share = attn_err(got, want)
    return list(q.to_local().shape), err, share


def phase_spmd_attention(rp, run, seed, card):
    """``spmd_attention_case`` on every rank of a (2, 1) and a (2, 2) mesh
    ("heads" mode: qwen's 8 kv heads split over the model axis), each
    rank's block within the attention limit. Its launches come after the
    tenant's were read and are not counted."""
    out = {}
    for shape, ranks in (((2, 1), rp.ranks[:2]), ((2, 2), rp.ranks)):
        mesh = rp.mesh(shape, ("data", "model"), ranks)
        rows = rp.run_on(mesh.ranks, spmd_attention_case, mesh.key, run,
                         seed)
        out[str(shape)] = [{"rank": str(r), "local_q": local,
                            "max_abs_err": err, "share_of_limit": share}
                           for r, (local, err, share) in zip(mesh.ranks,
                                                             rows)]
    log("spmd attention vs the plain attention on each rank's blocks: " + " | ".join(
        f"{m} {row['rank']} q {tuple(row['local_q'])} err "
        f"{row['max_abs_err']:.3g} ({row['share_of_limit']:.3g} of the "
        f"limit)" for m, rows in out.items() for row in rows) + f" | {card}")
    for m, rows in out.items():
        for row in rows:
            check(row["share_of_limit"] <= 1,
                  f"spmd attention on {m}, {row['rank']}: max_abs_err "
                  f"{row['max_abs_err']} ({row['share_of_limit']:.3g} of "
                  "the limit)")
    return out


def param_drift(got, twin) -> float:
    """The largest, over the param leaves, of |got - the twin's| over
    |the twin's - its init| (L2 norms, after the same SPMD_TWIN_STEPS
    steps): how far
    the sharded run's params lie from the one-device run's, in units of
    what the steps moved them."""
    worst = 0.0
    for p, want in twin["params_n"].items():
        move = float((want - twin["params0"][p]).norm())
        d = float((got[p].float() - want).norm())
        worst = max(worst, d / move if move else (0.0 if d == 0 else
                                                  float("inf")))
    return worst


#: ``repro_torch.launch.train``'s ``main`` with its run cut by
#: ``cut_layers`` (the launcher keeps the JAX launcher's flags; the depth
#: is this script's cut), for ``python -c`` with this script's directory
#: on the path
SPMD_LAUNCH_CODE = """
import sys
import chip_smoke
from repro_torch.launch import train
make = train.make_run_config
train.make_run_config = lambda *a, **k: chip_smoke.cut_layers(make(*a, **k))
sys.exit(train.main(sys.argv[1:]))
"""


def cut_layers(run):
    """``run`` at full width, its model cut to SPMD_LAYERS."""
    return run.replace(model=dataclasses.replace(run.model,
                                                 num_layers=SPMD_LAYERS))


def spmd_launch_args(wd: str, steps: int = SPMD_LAUNCH_STEPS) -> list:
    return ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--steps", str(steps), "--lr", TRAIN_LR,
            "--warmup", "5", "--workdir", wd, "--checkpoint-every", "0",
            "--log-every", "0", "--device", "cuda"]


def start_spmd_launch() -> dict:
    """``repro_torch.launch.train``'s ``main`` (``SPMD_LAUNCH_CODE``) as a
    2-rank world on the card (gloo, the (2, 1) mesh; rank 0 writes the
    metrics and the full-value checkpoint), started beside the train
    group; ``phase_spmd_launch`` reads it."""
    import socket
    wd = tempfile.mkdtemp(prefix="spmd_launch_")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    job = start_command(
        [([sys.executable, "-c", SPMD_LAUNCH_CODE, *spmd_launch_args(wd)],
          dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(port)))
         for r in range(2)], "launch.train on 2 ranks")
    job["workdir"] = wd
    return job


def phase_spmd_launch(torch, workdir, card, job):
    """The 2-rank ``launch.train`` that ``start_spmd_launch`` started
    (``job``) against the same arguments and cut on one rank in this
    process: SPMD_LAUNCH_STEPS steps each, per-step losses within
    SPMD_LOSS_TOL."""
    from unittest import mock

    from repro_torch.launch import train as launch

    def metrics(wd, wall):
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        return {"losses": [m["loss"] for m in lines],
                "step_ms": [m["step_s"] * 1e3 for m in lines],
                "wall_s": wall}
    make = launch.make_run_config
    wd = os.path.join(workdir, "launch_1")
    t0 = time.perf_counter()
    with mock.patch.object(launch, "make_run_config",
                           lambda *a, **k: cut_layers(make(*a, **k))):
        launch.train(launch.parser().parse_args(spmd_launch_args(wd)))
    out = {1: metrics(wd, time.perf_counter() - t0)}
    release(torch)
    try:
        _, wall, _ = finish_command(job, DIST_TIMEOUT_S)
        out[2] = metrics(job["workdir"], wall)
    finally:
        shutil.rmtree(job["workdir"], ignore_errors=True)
    diff = max(abs(a - b) for a, b in zip(out[1]["losses"],
                                          out[2]["losses"]))
    check(len(out[2]["losses"]) == SPMD_LAUNCH_STEPS
          and diff <= SPMD_LOSS_TOL,
          f"launch.train 2 ranks {out[2]['losses']} vs 1 rank "
          f"{out[1]['losses']}")
    log(f"launch.train qwen3-0.6b full width {SPMD_LAYERS} layers, 2-rank "
        f"world (2, 1) vs 1 rank: losses {out[2]['losses']} vs "
        f"{out[1]['losses']} (max diff {diff:.3g}) | step ms 2 ranks "
        f"{', '.join(f'{x:.0f}' for x in out[2]['step_ms'])}, 1 rank "
        f"{', '.join(f'{x:.0f}' for x in out[1]['step_ms'])} | wall "
        f"{out[2]['wall_s']:.1f} s (beside the train group) / "
        f"{out[1]['wall_s']:.1f} s | {card}")
    return {"by_world": {str(k): v for k, v in out.items()},
            "max_loss_diff": diff}


def start_spmd_pool():
    """Start the ``RankPool`` of ``run_spmd`` on a thread, so that its
    workers' start (a CUDA context and a gloo world, ~14-24 s) overlaps
    the groups before it; ``run_spmd`` takes the job."""
    import threading
    job = {}

    def start():
        from repro_torch.core.ranks import RankPool
        t0 = time.perf_counter()
        try:
            job["pool"] = RankPool(SPMD_RANKS, device="cuda")
        except BaseException as e:     # surfaced by run_spmd
            job["error"] = e
        job["start_s"] = time.perf_counter() - t0
    job["thread"] = threading.Thread(target=start, daemon=True)
    job["thread"].start()
    return job


def run_spmd(torch, ops, args, card, report, launches, workdir, job,
             launch_job):
    """The train tenant sharded over its VF's mesh: the ``RankPool`` of
    SPMD_RANKS workers on the card (gloo) that ``start_spmd_pool``
    started, one tenant through plain and int8 reshards
    (``spmd_tenant``) held against the same tenant on one device of this
    process; then ``launch.train`` over a 2-rank world. The workers'
    launches go into ``launches``."""
    from repro_torch.core import SVFFManager, Tenant
    from repro_torch.data.pipeline import SyntheticSource, to_device
    from repro_torch.train.step import make_eval_step
    from repro_torch.tree import flatten
    run = spmd_run(args.seed)
    t_group = time.perf_counter()
    twin = Tenant("spmd_twin", run, local_batch=TRAIN_BATCH,
                  seq_len=TRAIN_SEQ, seed=args.seed, device="cuda")
    SVFFManager(train_pool(), workdir=os.path.join(workdir, "twin")).init(
        1, [twin])
    eval_batch = SyntheticSource(run, batch_override=TRAIN_BATCH,
                                 seq_override=TRAIN_SEQ).batch_at(
                                     1000 + args.seed)

    def params():
        return {p: x.detach().to("cpu", torch.float32, copy=True)
                for p, x in flatten(
            twin.export_state())[0] if p.startswith("['params']")}
    ref = {"params0": params(), "eval_batch": eval_batch,
           "state_bytes": state_bytes(torch, twin.export_state())}
    ms = [twin.run_steps(1) for _ in range(SPMD_TWIN_STEPS)]
    ref["params_n"] = params()
    ref["eval_loss"] = float(make_eval_step(run)(
        twin.export_state()["params"], to_device(eval_batch, "cuda"))["loss"])
    ms.append(twin.run_steps(1))
    ref["losses"] = [m["loss"] for m in ms]
    ref["grad_norms"] = [m["grad_norm"] for m in ms]
    ref["step_ms"] = [x * 1e3 for x in twin.step_times]
    del twin, params
    release(torch)
    res = {"layers": SPMD_LAYERS, "ranks": SPMD_RANKS,
           "twin": {k: v for k, v in ref.items()
                    if k not in ("eval_batch", "params0", "params_n")}}
    t0 = time.perf_counter()
    job["thread"].join()
    res["pool_wait_s"] = time.perf_counter() - t0
    res["pool_start_s"] = job["start_s"]
    if "error" in job:
        raise job["error"]
    with job["pool"] as rp:
        res["tenant"] = spmd_tenant(torch, rp, run, args.seed, workdir, ref,
                                    card)
        for k in SPMD_KERNELS:
            launches[k] = launches.get(k, 0) + res["tenant"]["launches"][k]
        res["attention"] = phase_spmd_attention(rp, run, args.seed, card)
    res["launch_train"] = phase_spmd_launch(torch, workdir, card,
                                            launch_job)
    res["group_s"] = time.perf_counter() - t_group
    log(f"spmd group: {res['group_s']:.1f} s (rank pool start "
        f"{res['pool_start_s']:.1f} s beside the earlier groups, "
        f"{res['pool_wait_s']:.1f} s waited) | one-device twin step ms "
        f"{', '.join(f'{x:.0f}' for x in ref['step_ms'])} | {card}")
    report["spmd"] = res


# ---------------------------------------------------------------------------
# the sim plane: scenario sweep, crash matrix, pause path, state on the card
# ---------------------------------------------------------------------------
SIM_POLICIES = ("first_fit", "best_fit", "fair_share")
SIM_SWEEP_S = 60.0       # the first sweep pass fills about this long
SIM_SERVE_SWEEP_S = 20.0  # the second (serve 0.3, crash 0.1) pass
SIM_CRASH_SEEDS = 3
PAUSE_PATH_REPEATS = 3
PAUSE_PATH_KERNELS = ("qdma_pack", "qdma_pack_rows", "qdma_unpack")


def phase_sim_sweep(torch, card, device, budget_s: float, **rates):
    """``bench.scenario_sweep.sweep`` at the JAX benchmark's config (24 ops,
    16 devices, leaf 16, three policies), every invariant after every op,
    with the seed count set to fill ``budget_s`` from a timed pass of four
    seeds after a warm-up seed (the first scenario of a process pays its
    streams and pinned buffers). The sweep proper starts at seed 5. The
    runner checks after every op that every running tenant's state leaves
    are tensors on ``device``."""
    from repro_torch.bench.scenario_sweep import sweep
    sweep(SIM_POLICIES, 1, 24, 16, device=device, **rates)
    t0 = time.perf_counter()
    sweep(SIM_POLICIES, 4, 24, 16, seed0=1, device=device, **rates)
    per = (time.perf_counter() - t0) / (4 * len(SIM_POLICIES))
    n = max(2, int(budget_s / (per * len(SIM_POLICIES))))
    rep = sweep(SIM_POLICIES, n, 24, 16, seed0=5, device=device, **rates)
    for policy, row in rep["policies"].items():
        lat = ("no reconfs" if not row["reconfs"] else
               f"reconf p50 {row['reconf_p50_ms']:.3f} ms, p95 "
               f"{row['reconf_p95_ms']:.3f} ms ({row['reconfs']} reconfs)")
        log(f"sim sweep {json.dumps(rates) if rates else 'default'} "
            f"{policy}: {n} seeds, {row['ops']} ops ({row['ops_ok']} ok, "
            f"{row['rejected']} rejected) in {row['wall_s']:.2f} s, "
            f"{row['ops_per_sec']:.1f} ops/s | {lat} | every invariant "
            f"after every op, every running tenant's state on {device} | "
            f"{card}")
    return rep


def phase_sim_crash(card, device):
    """The 19 crash points (the core ops', request migration's and the
    gang ops') x seeds 0-2 x three policies, tenants on ``device``: each
    cell recovers green (I1-I8 with I4 bit-identical, I9, the catalogued
    outcome, I14 and the gang's width in a gang cell, liveness); a red
    cell raises."""
    from repro_torch.bench.crash_matrix import run_matrix
    rep = run_matrix(None, SIM_CRASH_SEEDS, SIM_POLICIES, device=device)
    s = rep["summary"]
    check(len(rep["protocol"]["points"]) == 19 and s["all_green"]
          and s["num_cases"]
          == len(rep["protocol"]["points"]) * SIM_CRASH_SEEDS * 3,
          f"crash matrix: {s['num_failures']} of {s['num_cases']} cells "
          f"failed ({rep['failures'][:2]})")
    log(f"sim crash matrix: {s['points']} points x {s['seeds']} seeds x "
        f"{len(s['policies'])} policies = {s['num_cases']} cells green in "
        f"{s['wall_s']:.2f} s (I1-I9, outcome, liveness) | {card}")
    return rep


def pause_path_kernels(torch, ops, card, device):
    """The staging kernels at the pause path's shapes, before it is timed:
    qdma_pack and qdma_unpack on the bench state's embedding (640-wide
    rows) and an MLP leaf (1920-wide rows) at the int8 rows' block, and
    qdma_pack_rows and qdma_unpack on every row descriptor the
    int8_pipelined engine issues for them; each output bit for bit against
    the plain version on the same inputs."""
    from repro_torch.bench import pause_path
    from repro_torch.core.staging import StagingEngine
    from repro_torch.kernels.ref import row_view
    B = pause_path.BLOCK
    eng = StagingEngine(num_queues=8, compression="int8", block=B)
    params = pause_path.bench_state(device)["params"]
    leaves = {"embed": params["embed"]["tok"],
              "ffn wi": params["decoder"]["layers"]["block0"]["ffn"]["wi"]}
    for name, x in leaves.items():
        q, s = ops.qdma_pack(x, block=B)
        wq, ws = ops.qdma_pack(x, block=B, backend="ref")
        u = ops.qdma_unpack(q, s, dtype=x.dtype)
        wu = ops.qdma_unpack(q, s, dtype=x.dtype, backend="ref")
        torch.cuda.synchronize()
        check(bits_equal(torch, q, wq) and bits_equal(torch, s, ws)
              and bits_equal(torch, u, wu),
              f"pause path {name} {tuple(x.shape)}: qdma_pack or qdma_unpack "
              "differs from the plain version")
        R, L = eng._row_view_dims(x)
        ranges = eng._row_chunks(x.numel() * x.element_size(), R)
        check(len(ranges) > 1, f"pause path {name}: one descriptor only")
        dst = torch.empty_like(x)
        for lo, hi in ranges:
            rq, rs = ops.qdma_pack_rows(x, lo, rows=hi - lo, block=B)
            wrq, wrs = ops.qdma_pack_rows(x, lo, rows=hi - lo, block=B,
                                          backend="ref")
            qd, sd = row_view(q)[lo:hi], row_view(s)[lo:hi]
            ops.qdma_unpack(qd, sd, out=row_view(dst)[lo:hi])
            wd = ops.qdma_unpack(qd, sd, backend="ref")
            torch.cuda.synchronize()
            check(bits_equal(torch, rq, wrq) and bits_equal(torch, rs, wrs)
                  and bits_equal(torch, row_view(dst)[lo:hi], wd),
                  f"pause path {name} rows [{lo}, {hi}): qdma_pack_rows or "
                  "qdma_unpack differs from the plain version")
        log(f"pause path kernels {name} {tuple(x.shape)} fp32, block {B}: "
            f"qdma_pack, qdma_unpack and {len(ranges)} row descriptors "
            f"({', '.join(f'[{lo},{hi})' for lo, hi in ranges)}) of "
            f"qdma_pack_rows and qdma_unpack bit-exact against the plain "
            f"versions | {card}")


def phase_pause_path(torch, ops, card, device):
    """``bench.pause_path`` (HC1-HC5) on the qwen3-100m-bench train state
    on ``device``, its staging kernels first held bit for bit against the
    plain versions at its shapes: the bench raises unless every non-int8
    row restores bit-equal and every int8 row within each block's bound;
    here an unchanged incremental save must move nothing, the live pause's
    stall stay under the stop-the-world total, and the int8 rows launch
    the pack, row pack and unpack kernels. Returns (rows, launch
    counts)."""
    from repro_torch.bench import pause_path
    pause_path_kernels(torch, ops, card, device)
    release(torch)
    ops.reset_launch_counts()
    rows = pause_path.bench(PAUSE_PATH_REPEATS, device=device)
    counts = ops.launch_counts()
    by = {r["name"]: r for r in rows}
    check(by["incremental_unchanged"]["bytes_moved"] == 0,
          "pause path: an unchanged incremental save moved "
          f"{by['incremental_unchanged']['bytes_moved']} bytes")
    check(by["pause_live_precopy"]["stop_ms"]
          < by["pause_stop_world"]["total_ms"],
          "pause path: the live pause stalled longer than a stop-the-world "
          "pause takes")
    for name in ("int8", "int8_pipelined"):
        check(0 < by[name]["int8_bound_share"] <= 1,
              f"pause path {name}: bound share "
              f"{by[name]['int8_bound_share']}")
    for k in PAUSE_PATH_KERNELS:
        check(counts[k] > 0,
              f"{k} was never launched on the pause path")
    gb = rows[0]["logical_bytes"] / 1e9
    for r in rows:
        if "save_ms" in r:
            log(f"pause path {r['name']} ({gb:.3f} GB state): save "
                f"{r['save_ms']:.2f} ms ({r['save_gbps']:.2f} GB/s, "
                f"{r['bytes_moved']:,} B), restore {r['restore_ms']:.2f} ms "
                f"({r['restore_gbps']:.2f} GB/s) | max rel err "
                f"{r['max_rel_err']:.3g}, int8 bound share "
                f"{r['int8_bound_share']:.6g} | {card}")
        else:
            log(f"pause path {r['name']}: total {r['total_ms']:.2f} ms, "
                f"stop {r['stop_ms']:.2f} ms ({r['stop_bytes_moved']:,} B "
                f"in the stop) | {card}")
    log(f"pause path launches {json.dumps({k: counts[k] for k in PAUSE_PATH_KERNELS})}")
    return rows, counts


def run_sim(torch, ops, card, report, launches, lane):
    """The sim plane's phases on the card: the crash matrix and the two
    sweeps from the host lane (``lane``, joined here), the pause path in
    this process with its staging kernel launches added to
    ``launches``."""
    device = torch.device("cuda")
    report["sim_crash"] = lane_phase(lane, "sim_crash")
    rows, counts = phase_pause_path(torch, ops, card, device)
    report["pause_path"] = {"rows": rows, "launches": counts}
    for k in PAUSE_PATH_KERNELS:
        launches[k] = launches.get(k, 0) + counts[k]
    release(torch)
    report["sim_sweep"] = lane_phase(lane, "sim_sweep")
    report["sim_sweep_serve_crash"] = lane_phase(lane,
                                                 "sim_sweep_serve_crash")
    close_lane(lane)


# ---------------------------------------------------------------------------
# the other model families
# ---------------------------------------------------------------------------
OLMOE, ARCTIC_1L = "olmoe-1b-7b", "arctic-480b-1l"
OLMOE_LAYERS = 4         # olmoe-1b-7b at full width, 4 of its 16 layers:
                         # its checks (margins, streams, the group rule)
                         # hold at any depth, and at 16 layers the
                         # families took 192.8 s of the script's 1,200,
                         # which then ended at 1,247 s (PERF.md)
JAMBA_MOE = "jamba-1.5-large-398b"
FAMILY_SERVE_KERNELS = {"dense": ("flash_attention", "fused_sample"),
                        "paged": ("flash_attention", "paged_decode",
                                  "fused_sample"),
                        "int8": ("flash_attention", "paged_decode_quant",
                                 "fused_sample")}


def family_requests(n: int, lens: str, new: int = 32):
    """A request factory: ``n`` requests of ``new`` tokens, half greedy,
    half at temperature 0.8 (top-k 50 on a quarter), prompts drawn from
    the seed under a family's sequence rule: "moe" 5-512 tokens (the MoE
    group rule), the first two 384 and 512; "chunk128" at most 128 or a
    multiple of 128 (the mLSTM chunk rule), three of them 256, 384 and
    512; "chunk16" the same at jamba's smoke chunk of 16; "any" 5-600,
    the first two 384 and 600."""
    def make(Request, vocab: int, seed: int):
        rng = np.random.default_rng(seed + 400)
        if lens == "moe":
            ls = rng.integers(5, 513, n)
            ls[:2] = (384, 512)
        elif lens == "chunk128":
            ls = rng.integers(5, 129, n)
            ls[:3] = (256, 384, 512)
        elif lens == "chunk16":
            ls = rng.integers(4, 17, n)
            ls[:3] = (32, 64, 128)
        else:
            ls = rng.integers(5, 601, n)
            ls[:2] = (384, 600)
        return [Request(rid=i, prompt=rng.integers(0, vocab, int(L))
                        .astype(np.int32), max_new_tokens=new,
                        temperature=0.8 if i % 2 else 0.0,
                        top_k=50 if i % 4 == 1 else 0, seed=seed + i)
                for i, L in enumerate(ls[:n])]
    return make


def family_batch(torch, cfg, toks, seed):
    """A prefill batch: the tokens, with random patches (vision) or
    frames (encoder-decoder; S // frame_ratio) on the card, fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": toks}
    if cfg.frontend.kind == "vision":
        batch["patches"] = torch.randn(
            (toks.shape[0], cfg.frontend.num_patches, cfg.d_model),
            generator=g, device="cuda")
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn(
            (toks.shape[0], max(1, toks.shape[1] // cfg.frontend.frame_ratio),
             cfg.d_model), generator=g, device="cuda")
    return batch


def phase_family_prefill(torch, ops, run, params, seed, lengths, *,
                         states=False, floor=LOGITS_REL_TOL):
    """A stack's prefill logits through the kernels and through the plain
    versions, both at bf16 compute, each against the plain versions at
    fp32 compute on the same weights and inputs (random patches and
    frames: the serve path's are zeros, whose encoder output is exactly
    zero). At bf16 any change of rounding moves a deep stack by 1-2% of
    max |logit|, so a fixed limit on kernel vs plain cannot tell a kernel
    error from rounding: the kernel path is held to ``HYBRID_MARGIN``
    times the plain bf16 path's own distance, or ``floor`` where that is
    larger (qwen's limit for the families, whose MoE routers' near ties
    move tokens to other experts on either path). With ``states`` each
    mamba layer's final SSM state is held the same way, by the mean over
    layers (one layer's state alone is too noisy to hold). Returns the
    distances and the kernel path's launch counts."""
    import dataclasses
    from repro_torch.models.model import build_model
    plain_run = run.replace(kernel_backend="reference")
    paths = {"kernel": build_model(run), "plain": build_model(plain_run)}
    exact = build_model(plain_run.replace(precision=dataclasses.replace(
        run.precision, compute="float32")))
    cparams = paths["kernel"].compute_params(params)
    rng = np.random.default_rng(seed + 500)
    res, counts = {}, dict.fromkeys(ops.LAUNCHES, 0)
    name = run.model.name

    def ssm_states(cache):
        return {blk: node["ssm"] for blk, node in cache.items()
                if "ssm" in node} if states else {}

    for S in lengths:
        toks = torch.tensor(rng.integers(0, run.model.vocab_size, (1, S)),
                            device="cuda")
        batch = family_batch(torch, run.model, toks, seed + S)
        ref_cache, ref = exact.prefill(params, batch)
        ref_states = ssm_states(ref_cache)
        del ref_cache
        scale = float(ref.abs().max())
        r, out = {}, {}
        for what, model in paths.items():
            ops.reset_launch_counts()
            cache, out[what] = model.prefill(cparams, batch)
            torch.cuda.synchronize()
            if what == "kernel":
                for k, v in ops.launch_counts().items():
                    counts[k] += v
            lg, st = out[what], ssm_states(cache)
            check(bool(torch.isfinite(lg).all()) and lg.shape == ref.shape,
                  f"{name} prefill S={S} {what}: non-finite or misshapen "
                  "logits")
            check(all(bool(torch.isfinite(t).all()) for t in st.values()),
                  f"{name} prefill S={S} {what}: non-finite SSM state")
            ssm = {blk: float((st[blk] - t).abs().max() / t.abs().max())
                   for blk, t in ref_states.items()}
            r[what] = {"logits": float((lg - ref).abs().max()) / scale,
                       **({"ssm": ssm,
                           "ssm_mean": float(np.mean(list(ssm.values())))}
                          if ssm else {})}
            del cache
        r["kernel_vs_plain"] = float((out["kernel"] - out["plain"]).abs()
                                     .max() / out["plain"].abs().max())
        k, p = r["kernel"], r["plain"]
        limit = max(HYBRID_MARGIN * p["logits"], floor)
        check(k["logits"] <= limit,
              f"{name} prefill S={S}: the kernel path's logits are "
              f"{k['logits']:.4g} of max |logit| from fp32 compute, over "
              f"{limit:.4g} (the plain bf16 path's {p['logits']:.4g})")
        line = (f"{name} prefill S={S} from the fp32-compute plain path (of "
                f"max |logit|): kernel path {k['logits']:.4g}, plain bf16 "
                f"path {p['logits']:.4g} (limit {limit:.4g})")
        if ref_states:
            check(k["ssm_mean"] <= HYBRID_MARGIN * p["ssm_mean"],
                  f"{name} prefill S={S}: the kernel path's SSM states are "
                  f"{k['ssm_mean']:.4g} of their max from fp32 compute "
                  f"(mean over layers), over {HYBRID_MARGIN} x the plain "
                  f"bf16 path's {p['ssm_mean']:.4g}")
            line += (" | SSM states (of each layer's max |state|): kernel "
                     "path " + ", ".join(f"{v:.4g}" for v in k["ssm"].values())
                     + f" (mean {k['ssm_mean']:.4g}), plain bf16 path "
                     + ", ".join(f"{v:.4g}" for v in p["ssm"].values())
                     + f" (mean {p['ssm_mean']:.4g}), limit {HYBRID_MARGIN}"
                     " x the plain path's mean")
        res[S] = r
        log(line + f" | kernel vs plain {r['kernel_vs_plain']:.4g}")
    del cparams
    check(counts["flash_attention"] > 0 or run.model.attention_free,
          f"{name}: flash_attention was never launched on the prefill")
    return {"rel_err": res, "launches": counts}


def family_serve(torch, ops, run, params, seed, card, requests, layouts,
                 pause=True):
    """Serve ``requests`` on each layout ("dense", "paged", "int8"): the
    fused stream's launches counted, host sampling's tokens equal to the
    fused ones (I10), and on the first layout a pause round trip (the
    cache staged to host memory; the params stay) token-identical.
    Returns {layout: metrics} with streams and launch counts."""
    out = {}
    name = run.model.name
    for i, layout in enumerate(layouts):
        kv = "int8" if layout == "int8" else None
        paged = layout != "dense"
        toks, met, counts = serve(torch, ops, run, params, kv, seed,
                                  count=True, requests=requests, paged=paged)
        host, _, _ = serve(torch, ops, run, params, kv, seed, fused=False,
                           requests=requests, paged=paged)
        check(host == toks, f"serve {name} {layout}: host sampling gives "
                            "other tokens than fused sampling (I10)")
        what = "fused == host sampling"
        if pause and i == 0:
            paused, _, _ = serve(torch, ops, run, params, kv, seed,
                                 pause_at=10, requests=requests,
                                 paged=paged, host_params=False)
            check(paused == toks, f"serve {name} {layout}: the pause round "
                                  "trip changed the tokens (I10)")
            what += ", pause round trip token-identical"
        want = FAMILY_SERVE_KERNELS[layout]
        if run.model.attention_free:
            want = ("fused_sample",)
        elif "mamba" in run.model.block_pattern:
            want += ("ssm_scan",)
        for k in want:
            check(counts[k] > 0, f"{k} was never launched serving {name} "
                                 f"({layout})")
        met.update(launches=counts, streams=toks)
        out[layout] = met
        log(f"serve {name} {layout}: {len(toks)} requests x "
            f"{len(toks[0])} tokens in {met['steps']} steps, "
            f"{met['wall_s']:.2f} s | decode step median "
            f"{met['decode_step_ms_median']:.2f} ms | "
            f"{met['tokens_per_s']:.1f} tokens/s | {card} | {what} | "
            f"launches {json.dumps({k: counts[k] for k in want})}")
    return out


def phase_group_rule(torch, run, params):
    """A 600-token prompt breaks the MoE group rule: the engine rejects it
    at admission with the rule's message (no prefill runs)."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(run, params, device="cuda", slots=8, max_len=1024)
    bad = Request(rid=0, prompt=np.zeros(600, np.int32), max_new_tokens=32)
    eng.submit(bad)
    eng.run_until_idle()
    check(bad.done and bad.error is not None and "group rule" in bad.error,
          f"{run.model.name}: a 600-token prompt was not rejected at "
          f"admission ({bad.error})")
    log(f"{run.model.name}: a 600-token prompt rejected at admission: "
        f"{bad.error}")
    return bad.error


def slstm_loop_ms(torch, run, params) -> float:
    """One sLSTM block's prefill of 256 tokens at B=2 (its per-token
    loop), timed after a warm call."""
    from repro_torch.models.model import build_model
    from repro_torch.models.xlstm import slstm_block
    cparams = build_model(run).compute_params(params)
    blk = next(f"block{j}" for j, k in enumerate(run.model.block_pattern)
               if k == "slstm")
    p = {k: v[0] for k, v in cparams["decoder"]["layers"][blk].items()}
    x = torch.randn((2, 256, run.model.d_model), device="cuda").to(
        torch.bfloat16)
    slstm_block(run.model, p, x, torch.bfloat16, mode="prefill")
    torch.cuda.synchronize()
    ts = time.perf_counter()
    slstm_block(run.model, p, x, torch.bfloat16, mode="prefill")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - ts) * 1e3
    log(f"{run.model.name}: one sLSTM block's 256-token loop at B=2 "
        f"{ms:.1f} ms")
    return ms


#: the families at full width (arctic cut to one layer, jamba at its
#: smoke widths): (arch, prefill lengths, request factory, layouts,
#: smoke); params are freed before the next model is built
FAMILIES = (
    (OLMOE, (384, 512), family_requests(16, "moe"),
     ("dense", "paged", "int8"), False),  # depth OLMOE_LAYERS
    ("llama3-8b", (384,), family_requests(8, "any"), ("paged",), False),
    ("phi3-mini-3.8b", (384, 600), family_requests(8, "any"), ("paged",),
     False),
    ("xlstm-350m", (), family_requests(8, "chunk128"), ("dense",), False),
    ("seamless-m4t-medium", (384, 600), family_requests(8, "any"),
     ("dense",), False),
    ("internvl2-1b", (384,), family_requests(8, "any"), ("dense", "paged"),
     False),
    (ARCTIC_1L, (384,), family_requests(4, "moe"), ("paged",), False),
    (JAMBA_MOE, (128,), family_requests(8, "chunk16"), ("paged",), True),
)


def run_families(torch, ops, args, card, report, launches):
    """Every other model family at full width, one after another, each
    model's params freed before the next is built: a prefill-logits check
    through the kernels (random patches and frames), the serve engine on
    the family's layouts with the serve phases' checks, and for olmoe the
    group rule's rejection at admission, for xlstm the generate path
    against the forward; with ``--profile`` a profiled paged decode step
    of each family that has pages (in ``chip_smoke.json``). Adds each
    serve path's launch counts to ``launches``."""
    from repro_torch.configs import make_run_config
    from repro_torch.models.model import build_model
    report["families"] = {}
    for arch, lengths, requests, layouts, smoke in FAMILIES:
        run = make_run_config(arch, "decode_32k", seed=args.seed,
                              smoke=smoke)
        if arch == OLMOE:
            run = run.replace(model=dataclasses.replace(
                run.model, num_layers=OLMOE_LAYERS))
        cfg = run.model
        t0 = time.perf_counter()
        params = build_model(run).init(seed=args.seed, device="cuda")
        torch.cuda.synchronize()
        rep = {"params": cfg.param_count(),
               "param_dtype": run.precision.params,
               "init_s": time.perf_counter() - t0}
        log(f"{cfg.name} params: {cfg.param_count():,} "
            f"{run.precision.params} on the card "
            f"({rep['init_s']:.1f} s, {allocated(torch, torch.device('cuda')) / 1e9:.1f} GB allocated)")
        if lengths:
            rep["prefill"] = phase_family_prefill(torch, ops, run, params,
                                                  args.seed, lengths)
            release(torch)
        if cfg.attention_free:
            rep["generate"] = phase_generate(torch, ops, run, params,
                                             args.seed)
            rep["slstm_block_prefill_ms"] = slstm_loop_ms(torch, run,
                                                          params)
            release(torch)
        if cfg.moe is not None and not smoke:
            rep["group_rule"] = phase_group_rule(torch, run, params)
        rep["serve"] = family_serve(torch, ops, run, params, args.seed, card,
                                    requests, layouts)
        if args.profile and "paged" in layouts:
            rep["profile"] = phase_profile(torch, run, params, args.seed,
                                           name=cfg.name, requests=requests)
        for met in rep["serve"].values():
            for k, v in met["launches"].items():
                launches[k] = launches.get(k, 0) + v
            met.pop("streams")
        report["families"][cfg.name] = rep
        del params
        release(torch)


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile eight decode steps of each model "
                         "(torch.profiler)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.configs import make_run_config
        from repro_torch.kernels import build, ops
        from repro_torch.models.model import build_model
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    # the commands started beside the groups end with this process
    atexit.register(stop_commands)

    def elapsed() -> float:
        return time.perf_counter() - t_start

    def mark(group: str):
        log(f"[{elapsed():.1f} s] {group}")

    # fp32 products in full fp32 (the tied-embedding logits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    report = {"card": card, "torch": torch.__version__}

    t0 = time.perf_counter()
    report["build_s"] = build.build()
    log(f"build: {json.dumps(report['build_s'])} "
        f"({time.perf_counter() - t0:.1f} s)")

    run = make_run_config("qwen3-0.6b", "decode_32k", seed=args.seed)
    cfg = run.model
    timer = Timer(torch)
    hcfg = make_run_config(HYBRID, "decode_32k").model
    # flash_decode first: its launch check is the process's first profiling
    fam = family_attention_shapes(
        lambda arch: make_run_config(arch, "decode_32k").model)
    scfg = make_run_config("seamless-m4t-medium", "decode_32k").model
    kern = {"flash_decode": phase_flash_decode(torch, ops, timer, hcfg),
            "flash_attention": phase_flash_attention(torch, ops, timer, cfg,
                                                     hcfg, fam),
            **phase_paged_decode(torch, ops, timer, cfg, hcfg, args.seed),
            "fused_sample": phase_fused_sample(torch, ops, timer, cfg,
                                               hcfg, scfg),
            "ssm_scan": phase_ssm_scan(torch, ops, timer, hcfg),
            **phase_qdma_pack(torch, ops, timer, cfg),
            "qdma_digest": phase_qdma_digest(torch, ops, timer, cfg)}
    del timer
    torch.cuda.empty_cache()

    mark("serve")
    # the lanes' jobs run beside this process's groups from here on
    lane = start_lane(card)
    model_lane = start_lane(card, "models", args)
    t0 = time.perf_counter()
    params = build_model(run).init(seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"qwen3-0.6b params: {cfg.param_count():,} fp32 on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    report["prefill_logits_rel_err"] = phase_prefill_logits(
        torch, run, params, args.seed)

    launches = dict.fromkeys(SERVE_KERNELS, 0)
    report["serve"] = {}
    paged = {}
    for kv in (None, "int8"):
        name = kv or "bf16"
        out, met, counts = serve(torch, ops, run, params, kv, args.seed,
                                 count=True)
        for k in SERVE_KERNELS:
            launches[k] += counts[k]
        host, _, _ = serve(torch, ops, run, params, kv, args.seed,
                           fused=False)
        check(host == out, f"serve kv={name}: host sampling gives other "
                           "tokens than fused sampling (I10)")
        paused, _, _ = serve(torch, ops, run, params, kv, args.seed,
                             pause_at=10)
        check(paused == out, f"serve kv={name}: the pause round trip "
                             "changed the tokens (I10)")
        met["launches"] = counts
        report["serve"][name] = met
        if kv is None:
            paged = {"streams": out,
                     "decode_step_ms_median": met["decode_step_ms_median"]}
        log(f"serve qwen3-0.6b kv={name}: 16 requests x 32 tokens in "
            f"{met['steps']} steps, {met['wall_s']:.2f} s | decode step "
            f"median {met['decode_step_ms_median']:.2f} ms | "
            f"{met['tokens_per_s']:.1f} tokens/s | {card} | fused == host "
            f"sampling, pause round trip token-identical | launches "
            f"{json.dumps(counts)}")
    for k in SERVE_KERNELS:
        check(launches[k] > 0, f"{k} was never launched on the serve path")

    # the SVFF path, each run with the counts set to 0 just before it
    workdir = tempfile.mkdtemp(prefix="svff_smoke_")
    try:
        ops.reset_launch_counts()
        report["svff"], ref = phase_svff(torch, run, params, args.seed,
                                         torch.device("cuda"), workdir)
        counts = ops.launch_counts()
        report["svff"]["launches"] = counts
        for k in ("flash_attention", "paged_decode", "fused_sample"):
            check(counts[k] > 0, f"{k} was never launched on the SVFF path")
        release(torch)
        ops.reset_launch_counts()
        report["svff_int8"] = phase_svff_int8(torch, run, params, args.seed,
                                              torch.device("cuda"), workdir)
        counts = ops.launch_counts()
        report["svff_int8"]["launches"] = counts
        for k in QDMA_KERNELS:
            check(counts[k] > 0, f"{k} was never launched on the int8 SVFF "
                                 "path")
            launches[k] = counts[k]
        release(torch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log_svff(report, card)
    mark("elastic")
    run_elastic(torch, ops, args, card, report, launches, params=params,
                ref=ref, lane=lane)
    mark("serve plane")
    # the elastic example's eight ranks run beside the serve plane and
    # pipeline groups
    example = start_elastic_example()
    run_serve_plane(torch, ops, args, card, report, launches, params, paged)
    mark("pipeline")
    run_pipeline(torch, ops, args, card, report, launches, params, ref, lane)
    mark("federation")
    # the distributed group's ranks run beside the federation group
    dist_job = start_ranks(DIST_RANKS, args.seed)
    run_federation(torch, ops, args, card, report, launches, params,
                   paged, lane)
    mark("distributed")
    finish_elastic_example(example, card, report)
    run_distributed(torch, ops, args, card, report, launches, params,
                    dist_job)
    mark("dry-run")
    run_dryrun(torch, ops, args, card, report, launches, params)
    mark("fp32")
    # its kernels are timed with no job of the lanes beside them
    waited = lane_wait(lane) + lane_wait(model_lane)
    log(f"fp32: waited {waited:.1f} s for the lanes' last jobs")
    run_fp32(torch, ops, args, card, report, launches, params, kern)
    if args.profile:
        report["profile"] = phase_profile(torch, run, params, args.seed)
    del params
    release(torch)

    mark("hybrid")
    # the 2-rank launch.train runs beside the train group
    spmd_launch = start_spmd_launch()
    lane_group(model_lane, "hybrid", report, launches)
    mark("train")
    # the sharded group's workers start beside the train group
    spmd_pool = start_spmd_pool()

    workdir = tempfile.mkdtemp(prefix="train_smoke_")
    try:
        run_train(torch, ops, args, card, report, launches, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    mark("spmd")
    workdir = tempfile.mkdtemp(prefix="spmd_smoke_")
    try:
        run_spmd(torch, ops, args, card, report, launches, workdir,
                 spmd_pool, spmd_launch)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    mark("families")
    lane_group(model_lane, "families", report, launches)
    close_lane(model_lane)
    mark("sim")
    run_sim(torch, ops, card, report, launches, lane)
    mark("end")

    sources = {"flash_attention": ("flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:77"),
               "flash_decode": ("flash_decode.cu",
                                "src/repro/kernels/flash_decode.py:60"),
               "ssm_scan": ("ssm_scan.cu",
                            "src/repro/kernels/ssm_scan.py:69"),
               "paged_decode": ("paged_decode.cu",
                                "src/repro/kernels/paged_decode.py:161"),
               "paged_decode_quant": ("paged_decode.cu",
                                      "src/repro/kernels/paged_decode.py:112"),
               "fused_sample": ("fused_sample.cu",
                                "src/repro/kernels/sampling.py:221"),
               "qdma_pack": ("qdma_pack.cu",
                             "src/repro/kernels/qdma_pack.py:53"),
               "qdma_pack_rows": ("qdma_pack.cu",
                                  "src/repro/kernels/qdma_pack.py:79"),
               "qdma_unpack": ("qdma_pack.cu",
                               "src/repro/kernels/qdma_pack.py:142"),
               "qdma_digest": ("qdma_pack.cu",
                               "src/repro/kernels/qdma_pack.py:117")}
    # the row of each kernel's main shape: flash_attention the S=384
    # prompt, flash_decode H=64 at an int pos 511, ssm_scan B=1 S=512
    # bf16, qdma the fp32 leaf or descriptor
    main_index = {"flash_attention": 2, "flash_decode": 2}
    line = []
    for name, (src, replaces) in sources.items():
        rows = kern[name] if isinstance(kern[name], list) else [kern[name]]
        main_row = rows[main_index.get(name, 0)]
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"]})
    report["kernels"] = kern
    report["log_times"] = LOG_TIMES
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for key, name in (("profile", "decode"), ("profile_hybrid",
                                              "hybrid_decode")):
        if key in report:
            with open(os.path.join(out_dir, f"profile_{name}.json"),
                      "w") as f:
                json.dump(report[key], f, indent=1)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
