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
the hybrid Mamba-attention stack, jamba-1.5-large-398b-1p-dense (one
period of Jamba-1.5-Large at every published width, 1 attention and 7
mamba layers, dense FFNs, bf16 params, random weights from ``--seed``):
prefill logits through the kernels against the plain versions, the paged
``ServeEngine`` with bf16 and int8 KV pages, and the uniform-position
generate path of ``make_serve_steps`` against the teacher-forced forward.

    python3 chip_smoke.py            # from the repository root

Phases: card, build, one phase per kernel, qwen serve (bf16, int8), SVFF
(bit-exact staging, int8 staging), hybrid prefill, hybrid serve (bf16,
int8), hybrid generate, kernels line, result line. Any failed check exits
non-zero before the result line. Details go to
``chiprun_out/chip_smoke.json``. The script imports only torch, numpy and
the port.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
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
FP32_FLOP_PER_S = 67e12

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


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str):
    print(msg, flush=True)


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


def attn_err(got, want):
    """(max |got - want|, the largest share of its limit ATTN_ATOL +
    ATTN_RTOL * |want| that any element uses; the check is share <= 1)."""
    d = (got.float() - want.float()).abs()
    lim = ATTN_ATOL + ATTN_RTOL * want.float().abs()
    return float(d.max()), float((d / lim).max())


def bound(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------
def phase_flash_attention(torch, ops, timer, cfg, hcfg):
    """flash_attention at qwen3-0.6b's prompt lengths (S 7, 200, 384 and
    its longest, 600; 16/8 heads of 128) and at the hybrid's prefill
    shape (S 512, 64/8 heads of 128)."""
    import torch.nn.functional as F
    hd = cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    shapes = [(S, cfg.num_heads, cfg.num_kv_heads) for S in (7, 200, 384, 600)]
    shapes.append((512, hcfg.num_heads, hcfg.num_kv_heads))
    for S, H, K in shapes:
        q, k, v = (torch.randn((1, S, n, hd), generator=g, device="cuda")
                   .to(torch.bfloat16) for n in (H, K, K))
        got = ops.flash_attention(q, k, v, causal=True)
        want = ops.flash_attention(q, k, v, causal=True, backend="ref")
        torch.cuda.synchronize()
        err, share = attn_err(got, want)
        label = f"q (1,{S},{H},{hd}) k/v {K} heads"
        check(share <= 1, f"flash_attention {label}: max_abs_err {err}, "
                          f"{share:.3g} of the limit")
        check(torch.equal(got, ops.flash_attention(q, k, v)),
              f"flash_attention {label}: not deterministic")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        ms = timer.ms(lambda: ops.flash_attention(q, k, v))
        plain = timer.ms(lambda: ops.flash_attention(q, k, v,
                                                     backend="ref"))
        nbytes = 2 * (2 * S * H * hd + 2 * S * K * hd)   # q, o, k, v bf16
        flops = 4 * H * hd * S * (S + 1) / 2             # causal QK^T + PV
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        rows.append({"shape": f"{label} bf16, causal",
                     "max_abs_err": err, "share_of_limit": share,
                     "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        log(f"flash_attention {label}: max_abs_err {err:.3g} ({share:.3g} "
            f"of the limit) | kernel {ms:.4f}"
            f" ms | plain {plain:.4f} ms | sdpa {lib:.4f} ms | bound "
            f"{b_ms:.4f} ms ({b_by})")
    return rows


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


def paged_inputs(torch, H, K, hd, positions, seed, quant: bool):
    """The serve engine's pool at B=8, page 16, NP 64 (max_len 1,024) and
    one page of garbage: q (8,1,H,hd) bf16, pages (513,16,K,hd), each
    slot's table a distinct run of a seeded permutation. Returns the
    kernel's arguments (int8 pages with their scales when ``quant``)."""
    from repro_torch.kernels.ref import kv_quant_ref
    B, page, NP = 8, 16, 64
    P = 1 + B * NP
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, 1, H, hd), generator=g, device="cuda").bfloat16()
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
    return q, kp.bfloat16(), vp.bfloat16(), tables, pos


def paged_work(q, kp, tables, pos, quant: bool):
    """(bytes, flops) of one call: q, the rows up to pos[b] of K and V
    (with their fp32 scales for int8 pages), tables and pos read once,
    the output written once; 4 flops per query head and element read."""
    B, _, H, hd = q.shape
    K = kp.shape[2]
    rows = int((pos + 1).clamp(min=0).sum())
    row_bytes = 2 * (hd + 4) if quant else 2 * 2 * hd
    nbytes = (rows * K * row_bytes + 2 * 2 * B * H * hd
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


def phase_fused_sample(torch, ops, timer, cfg, hcfg):
    """The sampler at qwen3-0.6b's padded vocabulary (the main row) and
    the hybrid's, B = 8 (greedy, temperature, top-k rows): bit-exact
    against the plain version, and one call puts one kernel on the card
    (one profiler session)."""
    from repro_torch.kernels.sampling import prepare_rows
    rows, calls = [], []
    for c in (cfg, hcfg):
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
    names = device_kernels(torch, calls)
    check(len(names) == len(calls) and all(name in n for n in names),
          f"{name}: {len(calls)} calls put {names} on the card, not one "
          "kernel each")
    log(f"{name}: {len(calls)} calls put {len(names)} kernels on the card, "
        f"all {name}")


def device_kernels(torch, calls, tries: int = 4) -> list:
    """The names of what the calls put on the card, kernels, copies and
    memsets alike, in one torch.profiler session (warm calls first).
    torch.profiler loses device work now and then: a session records
    nothing in a process that has profiled before, or misses one call's
    kernel (an H100 run recorded 5 kernels for 6 flash_decode calls). A
    record with fewer device events than calls is incomplete and the
    session is taken again, up to ``tries`` times; a record with as many
    or more is returned for the caller's check, so a call that puts no
    kernel, two kernels or a fill on the card still fails it. ``main``
    runs these sessions (every kernel phase's, flash_decode's first) before
    any other profiling."""
    from torch.profiler import ProfilerActivity, profile
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= len(calls):
            break
        log(f"profiler session {attempt + 1}: {len(names)} device events "
            f"for {len(calls)} calls, an incomplete record; taken again")
    return names


def phase_flash_decode(torch, ops, timer, cfg):
    """flash_decode at the generate path's shapes (B=4, T=1,024, hd 128,
    8 KV heads) with 64 and 16 query heads, at pos 0, 511 and 1,023, the
    position an int (as the generate path passes it) and a 0-d int32
    tensor on the card. Each call of either form must put exactly one
    kernel on the card: no merge launch, and no fill or copy for the
    position (one profiler session over a call of each form at each
    position)."""
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
    return rows


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
          pause_at=None, count=False, requests=make_requests):
    """Serve the 16 requests to completion; returns (token streams,
    metrics). With ``pause_at`` the engine is paused after that step, its
    device state staged to host memory and dropped, restored and
    unpaused."""
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.tree import tree_to
    eng = ServeEngine(run, params, device="cuda", slots=8, max_len=1024,
                      paged=True, page_size=16, kv_dtype=kv_dtype,
                      fused_sampling=fused)
    reqs = requests(Request, run.model.vocab_size, seed)
    for r in reqs:
        eng.submit(r)
    if count:
        ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_ms, steps = [], 0
    while steps < 2000:
        before = ops.LAUNCHES["flash_attention"]
        ts = time.perf_counter()
        n = eng.step()
        torch.cuda.synchronize()
        if n and ops.LAUNCHES["flash_attention"] == before:
            decode_ms.append((time.perf_counter() - ts) * 1e3)
        steps += 1
        if n == 0 and not eng.queue:
            break
        if steps == pause_at:
            eng.pause()
            st = eng.export_state()
            host = dict(st, params=tree_to(st["params"], "cpu"),
                        cache=tree_to(st["cache"], "cpu"))
            eng._cache = None
            torch.cuda.empty_cache()
            eng.import_state(host)
            eng.unpause()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts() if count else None
    check(all(r.done and r.error is None for r in reqs),
          f"serve kv={kv_dtype}: not every request completed")
    check(all(len(r.out) == 32 for r in reqs),
          f"serve kv={kv_dtype}: a request stopped short")
    toks = sum(len(r.out) for r in reqs)
    metrics = {"steps": steps, "wall_s": wall, "tokens": toks,
               "tokens_per_s": toks / wall,
               "decode_step_ms_median": float(np.median(decode_ms)),
               "decode_steps_timed": len(decode_ms)}
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


def make_fleet(run, params, device, workdir):
    """Two engine tenants of qwen3-0.6b (8 slots, max_len 1024, page 16,
    bf16 KV, fused sampling) over a pool of four logical slots."""
    from repro_torch.serve.fleet import ServeFleet
    return ServeFleet(run, params, num_engines=2, num_devices=4, slots=8,
                      max_len=1024, page_size=16, fused_sampling=True,
                      device=device, workdir=workdir)


def drive_fleet(fleet, reqs, schedule: dict, label: str) -> list:
    """Submit every request, step the fleet, running ``schedule[k]()``
    before fleet step k; drain, and check that every request completed.
    Returns the token streams."""
    for r in reqs:
        fleet.submit(r)
    for k in range(max(schedule, default=-1) + 1):
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
    device memory and the unpause bring it back."""
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
    return res


def int8_bound(torch, exported, eng, engine, label) -> float:
    """The restored state against the state the pause exported: each
    leaf the staging engine packed within its blocks' int8 bound, every
    other leaf equal. Returns the largest share of the bound used."""
    from repro_torch.kernels.ref import INV127
    from repro_torch.tree import flatten
    want = flatten({"params": exported["params"],
                    "cache": exported["cache"]})[0]
    got = flatten({"params": eng.params, "cache": eng._cache})[0]
    check([p for p, _ in want] == [p for p, _ in got],
          f"{label}: the restored state has another structure")
    for key in ("pos", "last_token", "tables"):
        check(np.array_equal(exported[key], getattr(eng, key)),
              f"{label}: {key} changed")
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
def phase_hybrid_prefill(torch, run, params, seed):
    """The hybrid's prefill through the kernels and through the plain
    versions, both with bf16 compute, each held against the plain
    versions with fp32 compute on the same weights and prompts: the last
    logits and each mamba layer's final SSM state. At bf16 any change of
    rounding moves this stack by 1-2% of max |logit|, so a fixed limit on
    kernel vs plain cannot tell a kernel error from rounding; the kernel
    path is held to ``HYBRID_MARGIN`` times the plain bf16 path's own
    distance from fp32 compute (one layer's state alone is too noisy to
    hold: the mean over layers is held)."""
    import dataclasses
    from repro_torch.models.model import build_model
    plain_run = run.replace(kernel_backend="reference")
    paths = {"kernel": build_model(run), "plain": build_model(plain_run)}
    exact = build_model(plain_run.replace(precision=dataclasses.replace(
        run.precision, compute="float32")))
    rng = np.random.default_rng(seed + 200)
    res = {}
    for S in (100, 384):
        toks = torch.tensor(rng.integers(0, run.model.vocab_size, (1, S)),
                            device="cuda")
        ref_cache, ref = exact.prefill(params, {"tokens": toks})
        ref_states = {blk: node["ssm"] for blk, node in ref_cache.items()
                      if "ssm" in node}
        del ref_cache
        r, out = {}, {}
        for name, model in paths.items():
            cache, out[name] = model.prefill(params, {"tokens": toks})
            check(bool(torch.isfinite(out[name]).all())
                  and out[name].shape == ref.shape,
                  f"hybrid prefill S={S} {name}: non-finite or misshapen "
                  "logits")
            check(all(bool(torch.isfinite(cache[blk]["ssm"]).all())
                      for blk in ref_states),
                  f"hybrid prefill S={S} {name}: non-finite SSM state")
            ssm = {blk: float((cache[blk]["ssm"] - st).abs().max()
                              / st.abs().max())
                   for blk, st in ref_states.items()}
            r[name] = {"logits": float((out[name] - ref).abs().max()
                                       / ref.abs().max()),
                       "ssm": ssm,
                       "ssm_mean": float(np.mean(list(ssm.values())))}
            del cache
        r["kernel_vs_plain"] = float((out["kernel"] - out["plain"]).abs()
                                     .max() / out["plain"].abs().max())
        res[S] = r
        log(f"hybrid prefill S={S}, from the fp32-compute plain path "
            f"(of max |logit|; of each layer's max |state|): kernel path "
            f"logits {r['kernel']['logits']:.4g}, states "
            + ", ".join(f"{v:.4g}" for v in r["kernel"]["ssm"].values())
            + f" (mean {r['kernel']['ssm_mean']:.4g}) | plain bf16 path "
            f"logits {r['plain']['logits']:.4g}, states "
            + ", ".join(f"{v:.4g}" for v in r["plain"]["ssm"].values())
            + f" (mean {r['plain']['ssm_mean']:.4g}) | limits "
            f"{HYBRID_MARGIN} x the plain path's | kernel vs plain path "
            f"logits {r['kernel_vs_plain']:.4g}")
    for S, r in res.items():
        k, p = r["kernel"], r["plain"]
        check(k["logits"] <= HYBRID_MARGIN * p["logits"],
              f"hybrid prefill S={S}: the kernel path's logits are "
              f"{k['logits']:.4g} of max |logit| from fp32 compute, over "
              f"{HYBRID_MARGIN} x the plain bf16 path's {p['logits']:.4g}")
        check(k["ssm_mean"] <= HYBRID_MARGIN * p["ssm_mean"],
              f"hybrid prefill S={S}: the kernel path's SSM states are "
              f"{k['ssm_mean']:.4g} of their max from fp32 compute (mean "
              f"over layers), over {HYBRID_MARGIN} x the plain bf16 "
              f"path's {p['ssm_mean']:.4g}")
    return res


def phase_generate(torch, ops, run, params, seed):
    """``make_serve_steps``' generate path: prefill B=4 prompts of 384
    tokens, widen the cache to a dense one of 1,024 positions, then 128
    decode steps with one position for the batch (384 ... 511), each
    step's logits against one teacher-forced forward at S=512. The launch
    counts cover the prefill and the decode steps only."""
    import dataclasses
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_serve_steps
    B, S0, S, T = 4, 384, 512, 1024
    model = build_model(run)
    prefill, decode = make_serve_steps(run)
    rng = np.random.default_rng(seed + 300)
    toks = torch.tensor(rng.integers(0, run.model.vocab_size, (B, S)),
                        device="cuda")
    ops.reset_launch_counts()
    cache, last = prefill(params, {"tokens": toks[:, :S0]})
    dense = model.init_cache(dataclasses.replace(run.shape, seq_len=T,
                                                 global_batch=B),
                             device="cuda")
    for blk, node in cache.items():
        for name, leaf in node.items():
            if name in ("k", "v"):
                dense[blk][name][:, :, :S0] = leaf
            else:
                dense[blk][name].copy_(leaf)
    del cache
    logits, step_ms = [last], []
    for t in range(S0, S - 1):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        lg, dense = decode(params, dense, toks[:, t:t + 1], t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        logits.append(lg)
    # the last step under the profiler: the kernels one step puts on the
    # card, by name
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lg, dense = decode(params, dense, toks[:, S - 1:S], S - 1)
        torch.cuda.synchronize()
    logits.append(lg)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = ops.launch_counts()
    del dense
    full = model.forward(params, {"tokens": toks})[0]
    scale = float(full.abs().max())
    errs = [float((lg - full[:, S0 - 1 + i]).abs().max())
            for i, lg in enumerate(logits)]
    check(all(np.isfinite(errs)), "generate: non-finite logits")
    check(max(errs) <= GEN_REL_TOL * scale,
          f"generate: decode logits differ from the forward by "
          f"{max(errs) / scale:.3g} of max |logit| (> {GEN_REL_TOL})")
    for k in GENERATE_KERNELS:
        check(counts[k] > 0, f"{k} was never launched on the generate path")
    n_attn = sum(1 for n in names if "flash_decode" in n)
    if names:       # the profiler saw the step's device work
        check(n_attn == counts["flash_decode"] // (S - S0),
              f"generate: the profiled step ran {n_attn} flash_decode "
              f"kernels, not one per attention layer")
    else:
        log("generate: the profiler recorded no device work for the last "
            "step")
    res = {"rel_err": max(errs) / scale, "steps": len(step_ms) + 1,
           "decode_step_ms_median": float(np.median(step_ms)),
           "launches": counts, "kernels_per_step": len(names),
           "fill_kernels_per_step": sum(1 for n in names
                                        if "fill" in n.lower()),
           "step_kernels": {n: names.count(n) for n in sorted(set(names))}}
    log(f"generate B={B} prefill {S0} + {res['steps']} uniform-pos decode "
        f"steps (T={T}): max rel err vs forward {res['rel_err']:.3g} "
        f"(tolerance {GEN_REL_TOL}) | decode step median "
        f"{res['decode_step_ms_median']:.2f} ms | a step: "
        f"{res['kernels_per_step']} kernels, "
        f"{res['fill_kernels_per_step']} fills | launches "
        f"{json.dumps({k: counts[k] for k in GENERATE_KERNELS})}")
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
    report["hybrid_prefill"] = phase_hybrid_prefill(torch, hrun, params,
                                                    args.seed)
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
    kern = {"flash_decode": phase_flash_decode(torch, ops, timer, hcfg),
            "flash_attention": phase_flash_attention(torch, ops, timer, cfg,
                                                     hcfg),
            **phase_paged_decode(torch, ops, timer, cfg, hcfg, args.seed),
            "fused_sample": phase_fused_sample(torch, ops, timer, cfg,
                                               hcfg),
            "ssm_scan": phase_ssm_scan(torch, ops, timer, hcfg),
            **phase_qdma_pack(torch, ops, timer, cfg),
            "qdma_digest": phase_qdma_digest(torch, ops, timer, cfg)}
    del timer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = build_model(run).init(seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"qwen3-0.6b params: {cfg.param_count():,} fp32 on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    report["prefill_logits_rel_err"] = phase_prefill_logits(
        torch, run, params, args.seed)

    launches = dict.fromkeys(SERVE_KERNELS, 0)
    report["serve"] = {}
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
        report["svff"] = phase_svff(torch, run, params, args.seed,
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
    if args.profile:
        report["profile"] = phase_profile(torch, run, params, args.seed)
    del params
    release(torch)

    run_hybrid(torch, ops, args, card, report, launches)

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
