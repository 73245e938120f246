#!/usr/bin/env python3
"""The port's kernels against an earlier version of their sources, in
one call on one NVIDIA GPU, in turns.

    mkdir -p build/old_csrc
    for f in flash_attention.cu flash_decode.cu paged_decode.cu ssm_scan.cu \\
             fused_sample.cu qdma_pack.cu common.cuh; do
        git show <rev>:src/repro_torch/kernels/csrc/$f > build/old_csrc/$f
    done
    python3 tools/attn_same_call.py --old build/old_csrc \\
        [--kernels attention paged ssm sample qdma]

    # fp32 flash_attention against the CUDA-core kernel of 44abb8d (alone)
    mkdir -p build/old_fp32
    for f in flash_attention.cu common.cuh; do
        git show 44abb8d:src/repro_torch/kernels/csrc/$f > build/old_fp32/$f
    done
    python3 tools/attn_same_call.py --old build/old_fp32 --kernels fp32

    # the fp32 paged decodes against the CUDA-core paths of 56737b4 (alone)
    mkdir -p build/old_paged_fp32
    for f in paged_decode.cu common.cuh; do
        git show 56737b4:src/repro_torch/kernels/csrc/$f \
            > build/old_paged_fp32/$f
    done
    python3 tools/attn_same_call.py --old build/old_paged_fp32 \
        --kernels paged_fp32

    # fp32 flash_decode against the CUDA-core kernel of 21c0d31 (alone)
    mkdir -p build/old_decode_fp32
    for f in flash_decode.cu common.cuh; do
        git show 21c0d31:src/repro_torch/kernels/csrc/$f \
            > build/old_decode_fp32/$f
    done
    python3 tools/attn_same_call.py --old build/old_decode_fp32 \
        --kernels decode_fp32

Builds the chosen kernels' old sources with nvcc beside the current ones
(into ``build/attn_same_call/``; the old sources share the old
``common.cuh``, so kernels compared against different revisions take one
run each), holds both versions against the plain
versions, and times them old, new, new, old with ``chip_smoke.py``'s
``Timer`` (CUDA events, L2 flushed before each call, the card kept busy
while the host enqueues), with the bound beside them, and prints the
timer's floor (a fill of one float). The old launchers must have the C
signatures of ``OLD_ARGTYPES``. The kernels, and their shapes:

``attention``: ``flash_attention`` and ``flash_decode``, with SDPA
beside them. ``flash_attention`` at qwen3-0.6b's prompts (S 7, 200, 384,
600; 16/8 heads of 128) and the hybrid's prefill (S 512, 64/8 heads),
the new kernel also with one and with two query heads a block;
``flash_decode`` at the generate path's cache (B 4, T 1,024, 8 KV heads
of 128; 64 and 16 query heads; pos 0, 511, 1,023), with the position an
int and a 0-d int32 tensor on the card. The old ``flash_decode`` runs as
its wrapper ran it: an int position became a tensor by ``torch.full``
inside the call, splits of 64 rows.

``fp32``: ``flash_attention`` on fp32 inputs at ``chip_smoke.py``'s
four fp32 rows (``fp32_attention_shapes``: qwen3-0.6b's S 384 and 600,
phi3-mini's hd 96, internvl2's G 7; causal), with SDPA at fp32 (tf32
off) beside them, held to JAX's fp32 limit 2e-5 + 2e-5 |plain|; each row
carries the bound by its bytes or its products at the 3xTF32
tensor-core rate (``FP32_ATTN_FLOP_PER_S``), the larger, and the new
kernel is also timed with each of ``FLASH_ATTENTION_FP32_ROWS`` query
rows a block forced. Then the same four shapes in bf16
through both libraries (the old revision's bf16 kernel against the
current one). Its old sources are a revision whose launcher already
takes the heads and fp32 arguments (``OLD_FP32_ARGTYPES``), so it runs
in a call of its own.

``paged_fp32``: ``paged_decode`` over fp32 pages and
``paged_decode_quant`` over int8 pages, both under fp32 q, at the serve
pool (``paged_inputs``: B 8, pages (513,16,8,128), NP 64, qwen3-0.6b's
16/8 heads) at ``PAGED_POS``, with no slot active and with every slot at
1,023, held to JAX's fp32 limit; each row carries the bound by its bytes
or its products at the rate the new kernel runs them (3xTF32,
``FP32_ATTN_FLOP_PER_S``, over fp32 pages; three bf16 products,
``FP32_QUANT_FLOP_PER_S``, over int8 pages), the larger. Beside each,
its bf16 twin (bf16 q over bf16 pages, over int8 pages) through both
libraries, whose old and new outputs must be the same bits. Its old
sources are a revision whose launchers already take the fp32 argument
(``OLD_PAGED_FP32_ARGTYPES``), so it runs in a call of its own.

``decode_fp32``: ``flash_decode`` on fp32 inputs at ``chip_smoke.py``'s
two fp32 rows (q (8,1,16,128) over k/v (8,1024,8,128), qwen3-0.6b's
heads, int pos 511 and 1,023), with no row valid (pos -1: zeros) and at
the fp32 generate path's shape (q (4,1,16,128) over (4,1024,8,128), pos
400), with SDPA at fp32 (tf32 off) and a plain read of the same rows
(``torch.amax`` over k and v up to pos) beside them, held to JAX's fp32
limit; each row carries the bound by its bytes or its products at the
3xTF32 rate (``FP32_ATTN_FLOP_PER_S``), the larger. Beside each, its bf16
twin through both libraries, whose old and new outputs must be the same
bits. Its old sources are a revision whose launcher already takes the
fp32 argument and an int position (``OLD_DECODE_FP32_ARGTYPES``), so it
runs in a call of its own.

``paged``: ``paged_decode`` and ``paged_decode_quant`` at
``chip_smoke.py``'s paged shapes (``paged_cases``: qwen3-0.6b's 16/8
heads at the timed positions, the hybrid's 64/8 heads, every slot
active), and at two more with qwen's heads: no slot active (what a call
costs beside its rows) and every slot at 1,023.

``ssm``: ``ssm_scan`` at ``chip_smoke.py``'s shapes (``phase_ssm_scan``:
the hybrid's 256 heads of 64, d_state 128, chunk 128; B 1 and 2 at S 100
and 512, B 4 at S 384, bf16 inputs, and fp32 at (1, 512)). Checked
within 1e-4 * max |plain|.

``sample``: ``fused_sample``'s kernel (``sample_rows``) at qwen3-0.6b's
padded vocabulary (151,936) and the hybrid's (65,536), B 8 and 1, rows
from ``prepare_rows`` (greedy, temperature and top-k); bit-exact.

``qdma``: the staging kernels at ``chip_smoke.py``'s shapes
(``phase_qdma_pack``): ``qdma_pack`` of qwen3-0.6b's fp32 MLP leaf at
blocks 128 and 256 and of a bf16 K pool at 128, ``qdma_pack_rows`` on one
save descriptor at both blocks, ``qdma_unpack`` of both leaves and of one
restore descriptor into its rows, each unpack with ``torch.mul`` beside
it (held to the same bits), and ``qdma_digest`` of the fp32 embedding;
bit-exact.

Prints one line per shape and writes ``chiprun_out/attn_same_call.json``.
Imports only torch, numpy, ``chip_smoke`` and the port.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the sources each kernel group builds
GROUPS = {"attention": ("flash_attention", "flash_decode"),
          "fp32": ("flash_attention",), "paged_fp32": ("paged_decode",),
          "decode_fp32": ("flash_decode",),
          "paged": ("paged_decode",), "ssm": ("ssm_scan",),
          "sample": ("fused_sample",), "qdma": ("qdma_pack",)}
#: the earlier launchers' C signatures, by source
OLD_ARGTYPES = {
    "flash_attention": {"launch_flash_attention": [P] * 4 + [I] * 7 + [P]},
    "flash_decode": {"launch_flash_decode": [P] * 8 + [I] * 6 + [P]},
    "paged_decode": {"launch_paged_decode": [P] * 6 + [I] * 6 + [P],
                     "launch_paged_decode_quant": [P] * 8 + [I] * 6 + [P]},
    "ssm_scan": {"launch_ssm_scan": [P] * 6 + [I] * 7 + [P]},
    "fused_sample": {"launch_fused_sample": [P, P, P, I, I, P]},
    "qdma_pack": {"launch_qdma_pack": [P, P, P, LL, I, I, P],
                  "launch_qdma_unpack": [P, P, P, LL, I, I, P],
                  "launch_qdma_digest": [P, LL, P, P]}}
#: the fp32 set's old launcher (44abb8d's: heads and fp32 arguments)
OLD_FP32_ARGTYPES = {
    "flash_attention": {"launch_flash_attention": [P] * 4 + [I] * 9 + [P]}}
#: the paged_fp32 set's old launchers (56737b4's: the fp32 argument)
OLD_PAGED_FP32_ARGTYPES = {
    "paged_decode": {"launch_paged_decode": [P] * 6 + [I] * 7 + [P],
                     "launch_paged_decode_quant": [P] * 8 + [I] * 7 + [P]}}
#: the decode_fp32 set's old launcher (21c0d31's: an int or device
#: position, the fp32 argument)
OLD_DECODE_FP32_ARGTYPES = {
    "flash_decode": {"launch_flash_decode": [P] * 5 + [I] * 9 + [P]}}
#: the groups that compare against a revision of their own: their old
#: launchers' signatures
ALONE = {"fp32": OLD_FP32_ARGTYPES, "paged_fp32": OLD_PAGED_FP32_ARGTYPES,
         "decode_fp32": OLD_DECODE_FP32_ARGTYPES}
OLD_DECODE_SPLIT = 64


def ptxas(text: str, label: str):
    """Print each kernel's registers and spills from ptxas -v's output."""
    name = "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"{label} ptxas {name}: {line.strip()}", flush=True)


def build_old(old_dir: str, stems, argtypes=OLD_ARGTYPES) -> dict:
    """nvcc each old source into a library of its own, with the port's
    flags (the sampler's bit-exact ones too), all at once; returns {stem:
    ctypes library}, its launchers bound with ``argtypes``, and prints
    ptxas's lines."""
    from repro_torch.kernels import build
    out_dir = os.path.join(ROOT, "build", "attn_same_call")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    for f in [f"{stem}.cu" for stem in stems] + ["common.cuh"]:
        shutil.copy(os.path.join(old_dir, f), out_dir)
    procs = {}
    for stem in stems:
        lib = os.path.join(out_dir, f"old_{stem}.so")
        procs[stem] = (lib, subprocess.Popen(
            [build.nvcc(), *build.BASE_FLAGS, *build.KERNELS[stem][0], "-o",
             lib,
             os.path.join(out_dir, f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (lib, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"old {stem}: nvcc exit {proc.returncode}\n"
                               + text[-4000:])
        ptxas(text, f"old {stem}")
        cdll = ctypes.CDLL(lib)
        for name, types in argtypes[stem].items():
            fn = getattr(cdll, name)
            fn.argtypes, fn.restype = types, I
        cdll.kernel_error_string.argtypes = [I]
        cdll.kernel_error_string.restype = ctypes.c_char_p
        libs[stem] = cdll
    return libs


class Turns:
    """Times an old and a new version old, new, new, old after holding
    both against the plain version; collects the rows."""

    def __init__(self, torch, cs, reps: int):
        self.torch, self.cs, self.reps = torch, cs, reps
        self.timer = cs.Timer(torch)
        self.rows = []

    def __call__(self, label, fns, want, nbytes, flops, *, lib=None,
                 share_fn=None, rate=None, **extra):
        """``fns``: {"old": fn, "new": fn}, each returning a tensor or a
        tuple of tensors; ``share_fn(got, want)``: the share of the limit
        (the attention kernels' by default); ``flops`` count at ``rate``
        (bf16 tensor cores by default); ``lib``: the library call timed
        beside them."""
        torch, cs = self.torch, self.cs
        share_fn = share_fn or (lambda got, want: cs.attn_err(got, want)[1])

        def same(a, b):
            a, b = ((a,), (b,)) if torch.is_tensor(a) else (a, b)
            return all(torch.equal(x, y) for x, y in zip(a, b))

        share = {}
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            share[name] = share_fn(got, want)
            cs.check(share[name] <= 1, f"{label} {name}: "
                                       f"{share[name]:.3g} of the limit")
            cs.check(same(got, fn()), f"{label} {name}: not deterministic")
        times = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            times[name].append(self.timer.ms(fns[name], reps=self.reps))
        lib_ms = self.timer.ms(lib, reps=self.reps) if lib else None
        b_ms, b_by = cs.bound(nbytes, flops, rate or cs.BF16_FLOP_PER_S)
        self.rows.append({"shape": label, "old_ms": times["old"],
                          "new_ms": times["new"],
                          "library_ms": lib_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "share_of_limit": share,
                          **extra})
        more = "" if lib_ms is None else f" | library {lib_ms:.4f} ms"
        print(f"{label}: old {times['old'][0]:.4f} / {times['old'][1]:.4f} "
              f"ms | new {times['new'][0]:.4f} / {times['new'][1]:.4f} ms"
              f"{more} | bound {b_ms:.4f} ms ({b_by}) | share of limit old "
              f"{share['old']:.3g} new {share['new']:.3g}", flush=True)


def current_attention(torch, stream, q, k, v, block):
    """The current flash_attention kernel, causal, with its block forced:
    one of ops.FLASH_ATTENTION_BF16_HEADS (query heads a block) for bf16,
    of ops.FLASH_ATTENTION_FP32_ROWS (query rows a block) for fp32; the
    wrapper passes FLASH_ATTENTION_AUTO, the launcher's choice."""
    from repro_torch.kernels import build
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    rc = lib.launch_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H,
        K, hd, 1, block, int(q.dtype == torch.float32), stream)
    if rc:
        raise RuntimeError(lib.kernel_error_string(rc).decode())
    return out


def time_attention(torch, cs, old, turns, stream):
    import torch.nn.functional as F
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops

    def old_attention(q, k, v):
        B, S, H, hd = q.shape
        T, K = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        rc = old["flash_attention"].launch_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            T, H, K, hd, 1, stream)
        if rc:
            raise RuntimeError(old["flash_attention"].kernel_error_string(rc))
        return out

    def old_decode(q, k, v, pos):
        B, _, H, hd = q.shape
        T, K = k.shape[1], k.shape[2]
        pos_t = (pos if isinstance(pos, torch.Tensor) else
                 torch.full((), int(pos), dtype=torch.int32, device="cuda"))
        G, nsplit = H // K, -(-T // OLD_DECODE_SPLIT)
        n = B * K * nsplit * G
        part = torch.empty((n * (hd + 2),), dtype=torch.float32,
                           device="cuda")
        out = torch.empty_like(q)
        rc = old["flash_decode"].launch_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_t.data_ptr(),
            part.data_ptr(), part[n:].data_ptr(), part[2 * n:].data_ptr(),
            out.data_ptr(), B, T, K, hd, G, OLD_DECODE_SPLIT, stream)
        if rc:
            raise RuntimeError(old["flash_decode"].kernel_error_string(rc))
        return out

    qwen = make_run_config("qwen3-0.6b", "decode_32k").model
    hyb = make_run_config(cs.HYBRID, "decode_32k").model
    g = torch.Generator(device="cuda").manual_seed(11)
    for S, H, K in [(S, qwen.num_heads, qwen.num_kv_heads)
                    for S in (7, 200, 384, 600)] + \
            [(512, hyb.num_heads, hyb.num_kv_heads)]:
        hd = qwen.head_dim
        q, k, v = (torch.randn((1, S, n, hd), generator=g, device="cuda")
                   .to(torch.bfloat16) for n in (H, K, K))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        want = ops.flash_attention(q, k, v, backend="ref")
        forced = {}
        for heads in ops.FLASH_ATTENTION_BF16_HEADS:
            got = current_attention(torch, stream, q, k, v, heads)
            cs.check(cs.attn_err(got, want)[1] <= 1,
                     f"flash_attention S={S} heads={heads}: off the limit")
            forced[heads] = turns.timer.ms(
                lambda: current_attention(torch, stream, q, k, v, heads),
                reps=turns.reps)
        print(f"flash_attention S={S} H={H}: query heads per block "
              + ", ".join(f"{n} {ms:.4f} ms" for n, ms in forced.items()),
              flush=True)
        turns(f"flash_attention q (1,{S},{H},{hd}) k/v {K} heads, causal",
              {"old": lambda: old_attention(q, k, v),
               "new": lambda: ops.flash_attention(q, k, v)},
              want, 2 * (2 * S * H * hd + 2 * S * K * hd),
              4 * H * hd * S * (S + 1) / 2,
              lib=lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True, enable_gqa=True),
              kernel="flash_attention", new_ms_by_heads_per_block=forced)
    K, hd, B, T = hyb.num_kv_heads, hyb.head_dim, 4, 1024
    for H in (hyb.num_heads, 16):
        g = torch.Generator(device="cuda").manual_seed(14 + H)
        q = torch.randn((B, 1, H, hd), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, T, K, hd), generator=g,
                            device="cuda").bfloat16() for _ in "kv")
        for pos in (0, 511, 1023):
            n = pos + 1
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (x[:, :n].transpose(1, 2).contiguous() for x in (k, v))
            want = ops.flash_decode(q, k, v, pos, backend="ref")
            pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
            for form, p in (("int", pos), ("tensor", pos_t)):
                turns(f"flash_decode q ({B},1,{H},{hd}) k/v ({B},{T},{K},"
                      f"{hd}) pos {pos} ({form})",
                      {"old": lambda: old_decode(q, k, v, p),
                       "new": lambda: ops.flash_decode(q, k, v, p)},
                      want, 2 * (2 * B * n * K * hd + 2 * B * H * hd) + 4,
                      4 * B * H * hd * n,
                      lib=lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, enable_gqa=True),
                      kernel="flash_decode")


def time_fp32(torch, cs, old, turns, stream):
    """fp32 flash_attention, old against new, at chip_smoke.py's fp32
    rows; then the bf16 kernel of both revisions at the same shapes."""
    import torch.nn.functional as F
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops
    lib = old["flash_attention"]

    def old_attention(q, k, v):
        B, S, H, hd = q.shape
        T, K = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        rc = lib.launch_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            T, H, K, hd, 1, 0, int(q.dtype == torch.float32), stream)
        if rc:
            raise RuntimeError(lib.kernel_error_string(rc).decode())
        return out

    def fp32_share(got, want):
        return cs.attn_err(got, want, cs.FP32_TOL, cs.FP32_TOL)[1]

    def get(arch):
        return make_run_config(arch, "decode_32k").model
    shapes = cs.fp32_attention_shapes(get("qwen3-0.6b"),
                                      cs.family_attention_shapes(get))
    g = torch.Generator(device="cuda").manual_seed(28)
    for dtype in (torch.float32, torch.bfloat16):
        kind = "fp32" if dtype == torch.float32 else "bf16"
        for S, H, K, hd, who in shapes:
            q, k, v = (torch.randn((1, S, n, hd), generator=g,
                                   device="cuda").to(dtype)
                       for n in (H, K, K))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            nbytes = q.element_size() * 2 * S * hd * (H + K)
            flops = 4 * H * hd * S * (S + 1) / 2
            fp32 = dtype == torch.float32
            want = ops.flash_attention(q, k, v, backend="ref")
            forced = {}
            for rows in ops.FLASH_ATTENTION_FP32_ROWS if fp32 else ():
                got = current_attention(torch, stream, q, k, v, rows)
                cs.check(fp32_share(got, want) <= 1,
                         f"flash_attention fp32 S={S} rows={rows}: off the "
                         "limit")
                forced[rows] = turns.timer.ms(
                    lambda: current_attention(torch, stream, q, k, v, rows),
                    reps=turns.reps)
            if forced:
                print(f"flash_attention fp32 S={S} H={H} hd={hd}: query rows "
                      "per block " + ", ".join(f"{n} {ms:.4f} ms"
                                               for n, ms in forced.items()),
                      flush=True)
            turns(f"flash_attention {kind} q (1,{S},{H},{hd}) k/v {K} "
                  f"heads, causal" + (f" ({who})" if who else ""),
                  {"old": lambda: old_attention(q, k, v),
                   "new": lambda: ops.flash_attention(q, k, v)},
                  want, nbytes, flops,
                  lib=lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True, enable_gqa=True),
                  share_fn=fp32_share if fp32 else None,
                  rate=cs.FP32_ATTN_FLOP_PER_S if fp32 else None,
                  kernel="flash_attention", dtype=kind,
                  new_ms_by_rows_per_block=forced)


def time_decode_fp32(torch, cs, old, turns, stream):
    """fp32 flash_decode, old against new, at chip_smoke.py's fp32 rows, no
    row valid and the generate path's shape, each beside its bf16 twin
    (whose old and new outputs must be the same bits)."""
    import torch.nn.functional as F
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops
    lib = old["flash_decode"]

    def old_decode(q, k, v, pos):
        B, _, H, hd = q.shape
        T, K = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        rows = max(ops.FLASH_DECODE_SPLIT,
                   -(-T // ops.FLASH_DECODE_MAX_SPLITS))
        rc = lib.launch_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            max(-1, min(pos, T - 1)), 0, B, T, K, hd, H // K, rows,
            int(q.dtype == torch.float32), stream)
        if rc:
            raise RuntimeError(lib.kernel_error_string(rc).decode())
        return out

    def fp32_share(got, want):
        return cs.attn_err(got, want, cs.FP32_TOL, cs.FP32_TOL)[1]

    qwen = make_run_config("qwen3-0.6b", "decode_32k").model
    H, K, hd, T = qwen.num_heads, qwen.num_kv_heads, qwen.head_dim, 1024
    g = torch.Generator(device="cuda").manual_seed(28)
    for B, pos in ((8, 511), (8, 1023), (8, -1), (4, 400)):
        base = [torch.randn(shape, generator=g, device="cuda")
                for shape in ((B, 1, H, hd), (B, T, K, hd), (B, T, K, hd))]
        n = max(pos + 1, 0)
        for dtype in (torch.float32, torch.bfloat16):
            fp32 = dtype == torch.float32
            kind = "fp32" if fp32 else "bf16"
            q, k, v = (x.to(dtype) for x in base)
            if not fp32:
                cs.check(torch.equal(old_decode(q, k, v, pos),
                                     ops.flash_decode(q, k, v, pos)),
                         f"flash_decode bf16 pos {pos}: the bf16 path's "
                         "bits changed")
            # no row valid: the kernels' zeros (the plain version averages
            # every row)
            want = (torch.zeros_like(q) if n == 0 else
                    ops.flash_decode(q, k, v, pos, backend="ref"))
            sdpa, read_ms = None, None
            if n:
                qt = q.transpose(1, 2).contiguous()
                kt, vt = (x[:, :n].transpose(1, 2).contiguous()
                          for x in (k, v))
                sdpa = (lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True))
                # a plain read of the rows the kernel reads: one reduction
                # over k and v up to pos, side by side
                rows = torch.stack((k[:, :n], v[:, :n]))
                read_ms = turns.timer.ms(lambda: torch.amax(rows),
                                         reps=turns.reps)
                mb = rows.numel() * q.element_size() / 1e6
                print(f"torch.amax over the {mb:.1f} MB of rows up to pos "
                      f"{pos} ({kind}): {read_ms:.4f} ms", flush=True)
                del rows
            turns(f"flash_decode {kind} q ({B},1,{H},{hd}), k/v ({B},{T},"
                  f"{K},{hd}), int pos {pos}",
                  {"old": lambda: old_decode(q, k, v, pos),
                   "new": lambda: ops.flash_decode(q, k, v, pos)},
                  want,
                  q.element_size() * (2 * B * n * K * hd + 2 * B * H * hd),
                  4 * B * H * hd * n, lib=sdpa,
                  share_fn=fp32_share if fp32 else None,
                  rate=cs.FP32_ATTN_FLOP_PER_S if fp32 else None,
                  kernel="flash_decode", dtype=kind, read_ms=read_ms)


def time_paged(torch, cs, old, turns, stream, seed):
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops
    lib = old["paged_decode"]

    def old_paged(quant, a):
        q, kp, tables, pos = a[0], a[1], a[-2], a[-1]
        B, _, H, hd = q.shape
        page, K = kp.shape[1], kp.shape[2]
        out = torch.empty_like(q)
        fn = (lib.launch_paged_decode_quant if quant
              else lib.launch_paged_decode)
        rc = fn(*[x.data_ptr() for x in a], out.data_ptr(), B,
                tables.shape[1], page, K, hd, H // K, stream)
        if rc:
            raise RuntimeError(lib.kernel_error_string(rc).decode())
        return out

    qwen = make_run_config("qwen3-0.6b", "decode_32k").model
    hyb = make_run_config(cs.HYBRID, "decode_32k").model
    K, hd = qwen.num_kv_heads, qwen.head_dim
    cases = cs.paged_cases(qwen, hyb, seed) + [
        ("no slot active", qwen.num_heads, [-1] * 8),
        ("every slot at 1023", qwen.num_heads, [1023] * 8)]
    for label, H, positions in cases:
        for quant in (False, True):
            name = "paged_decode_quant" if quant else "paged_decode"
            a = cs.paged_inputs(torch, H, K, hd, positions, 12 + quant,
                                quant)
            NP, page = a[-2].shape[1], a[1].shape[1]
            turns(f"{name} {label}: q {tuple(a[0].shape)}, NP {NP}, page "
                  f"{page}, pos {list(positions)}",
                  {"old": lambda: old_paged(quant, a),
                   "new": lambda: getattr(ops, name)(*a)},
                  getattr(ops, name)(*a, backend="ref"),
                  *cs.paged_work(a[0], a[1], a[-2], a[-1], quant),
                  kernel=name)


def time_paged_fp32(torch, cs, old, turns, stream, seed):
    """The paged decodes under fp32 q, old against new, at the serve pool
    with PAGED_POS, no slot active and every slot at 1,023, each beside
    its bf16 twin (whose old and new outputs must be the same bits)."""
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops
    lib = old["paged_decode"]

    def old_paged(quant, a):
        q, kp, tables, pos = a[0], a[1], a[-2], a[-1]
        B, _, H, hd = q.shape
        page, K = kp.shape[1], kp.shape[2]
        out = torch.empty_like(q)
        fn = (lib.launch_paged_decode_quant if quant
              else lib.launch_paged_decode)
        rc = fn(*[x.data_ptr() for x in a], out.data_ptr(), B,
                tables.shape[1], page, K, hd, H // K,
                int(q.dtype == torch.float32), stream)
        if rc:
            raise RuntimeError(lib.kernel_error_string(rc).decode())
        return out

    def fp32_share(got, want):
        return cs.attn_err(got, want, cs.FP32_TOL, cs.FP32_TOL)[1]

    qwen = make_run_config("qwen3-0.6b", "decode_32k").model
    H, K, hd = qwen.num_heads, qwen.num_kv_heads, qwen.head_dim
    for label, positions in (("serve pool", cs.PAGED_POS),
                             ("no slot active", [-1] * 8),
                             ("every slot at 1023", [1023] * 8)):
        for quant in (False, True):
            name = "paged_decode_quant" if quant else "paged_decode"
            for dtype in (torch.float32, torch.bfloat16):
                fp32 = dtype == torch.float32
                a = cs.paged_inputs(torch, H, K, hd, positions, 12 + quant,
                                    quant, dtype=dtype)
                if not fp32:
                    cs.check(torch.equal(old_paged(quant, a),
                                         getattr(ops, name)(*a)),
                             f"{name} bf16 {label}: the bf16 path's bits "
                             "changed")
                pages = "int8" if quant else ("fp32" if fp32 else "bf16")
                turns(f"{name} {label}, q {'fp32' if fp32 else 'bf16'} "
                      f"{tuple(a[0].shape)}, {pages} pages (513,16,{K},"
                      f"{hd}), NP 64, pos {list(positions)}",
                      {"old": lambda: old_paged(quant, a),
                       "new": lambda: getattr(ops, name)(*a)},
                      getattr(ops, name)(*a, backend="ref"),
                      *cs.paged_work(a[0], a[1], a[-2], a[-1], quant),
                      share_fn=fp32_share if fp32 else None,
                      rate=(cs.FP32_QUANT_FLOP_PER_S if quant else
                            cs.FP32_ATTN_FLOP_PER_S) if fp32 else None,
                      kernel=name, q_dtype="fp32" if fp32 else "bf16")


def time_ssm(torch, cs, old, turns, stream):
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import mamba_dims
    hyb = make_run_config(cs.HYBRID, "decode_32k").model
    _, H, _, _ = mamba_dims(hyb)
    hd, N, chunk = hyb.ssm.head_dim, hyb.ssm.d_state, hyb.ssm.chunk

    def old_scan(a):
        x, bv, cv, la = a
        B, S = x.shape[:2]
        y = torch.empty((B, S, H, hd), dtype=torch.float32, device="cuda")
        st = torch.empty((B, H, hd, N), dtype=torch.float32, device="cuda")
        lib = old["ssm_scan"]
        rc = lib.launch_ssm_scan(
            x.data_ptr(), bv.data_ptr(), cv.data_ptr(), la.data_ptr(),
            y.data_ptr(), st.data_ptr(), B, S, H, hd, N, min(chunk, S),
            int(x.dtype == torch.bfloat16), stream)
        if rc:
            raise RuntimeError(lib.kernel_error_string(rc).decode())
        return y, st

    def share(got, want):
        return max(float((g - w).abs().max())
                   / (cs.SSM_REL_TOL * float(w.abs().max()))
                   for g, w in zip(got, want))

    for B, S, dtype in cs.SSM_SHAPES:
        dt = getattr(torch, dtype)
        a = cs.ssm_inputs(torch, B, S, H, hd, N, dt)
        want = ops.ssm_scan(*a, chunk=chunk, backend="ref")
        kind = "bf16" if dt == torch.bfloat16 else "fp32"
        nbytes, flops, _ = cs.ssm_scan_work(B, S, H, hd, N, min(chunk, S),
                                            a[0].element_size())
        turns(f"ssm_scan xdt ({B},{S},{H},{hd}) {kind}, N {N}, Q "
              f"{min(chunk, S)}",
              {"old": lambda: old_scan(a),
               "new": lambda: ops.ssm_scan(*a, chunk=chunk)},
              want, nbytes, flops, share_fn=share, kernel="ssm_scan")


def time_sample(torch, cs, old, turns, stream):
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.sampling import prepare_rows

    def old_rows(z, keys4):
        out = torch.empty((z.shape[0],), dtype=torch.int32, device="cuda")
        lib = old["fused_sample"]
        rc = lib.launch_fused_sample(z.data_ptr(), keys4.data_ptr(),
                                     out.data_ptr(), z.shape[0], z.shape[1],
                                     stream)
        if rc:
            raise RuntimeError(lib.kernel_error_string(rc).decode())
        return out

    for arch in ("qwen3-0.6b", cs.HYBRID):
        c = make_run_config(arch, "decode_32k").model
        logits, temp, top_k, keys = cs.sample_inputs(torch, c)
        V, Vp = c.vocab_size, logits.shape[1]
        for B in (8, 1):
            # B = 1: the temperature row
            sel = slice(1, 2) if B == 1 else slice(None)
            z, noisy = prepare_rows(logits[sel], temp[sel], top_k[sel],
                                    vocab_size=V)
            keys4 = torch.cat([keys[sel], noisy.int()[:, None]],
                              1).contiguous()
            n_noisy = int(noisy.sum())
            turns(f"fused_sample z ({B},{Vp}) fp32",
                  {"old": lambda: old_rows(z, keys4),
                   "new": lambda: ops.sample_rows(z, keys4)},
                  ops.sample_rows(z, keys4, backend="ref"),
                  B * Vp * 4 + keys4.numel() * 4 + B * 4,
                  Vp * (n_noisy * cs.SAMPLE_OPS_PER_NOISY
                        + (B - n_noisy) * cs.SAMPLE_OPS_PER_GREEDY),
                  share_fn=lambda got, want: 0.0 if torch.equal(got, want)
                  else float("inf"),
                  rate=cs.FP32_FLOP_PER_S, kernel="fused_sample")


def time_qdma(torch, cs, old, turns, stream):
    from repro_torch.configs import make_run_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import bytes_view, row_view
    lib = old["qdma_pack"]

    def call(fn, *args):
        rc = fn(*args, stream)
        if rc:
            raise RuntimeError(lib.kernel_error_string(rc).decode())

    def old_pack(x, lo, rows, block, shape=None):
        L = x.shape[-1]
        q = torch.empty((rows, L), dtype=torch.int8, device="cuda")
        s = torch.empty((rows, L // block), dtype=torch.float32,
                        device="cuda")
        call(lib.launch_qdma_pack, x.data_ptr() + lo * L * x.element_size(),
             q.data_ptr(), s.data_ptr(), rows * (L // block), block,
             int(x.dtype == torch.bfloat16))
        if shape is None:
            return q, s
        return q.view(shape), s.view(shape[:-1] + (L // block,))

    def old_unpack(q, s, out):
        call(lib.launch_qdma_unpack, q.data_ptr(), s.data_ptr(),
             out.data_ptr(), q.numel(), q.shape[-1] // s.shape[-1],
             int(out.dtype == torch.bfloat16))
        return out

    def old_digest(x):
        u = bytes_view(x)
        out = torch.zeros((2,), dtype=torch.int32, device="cuda")
        call(lib.launch_qdma_digest, u.data_ptr(), u.numel(), out.data_ptr())
        return out.to(torch.int64) & 0xFFFFFFFF

    def exact(got, want):
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        return 0.0 if all(cs.bits_equal(torch, a, b)
                          for a, b in zip(got, want)) else float("inf")

    def row(label, fns, want, nbytes, ops_per, lib=None):
        turns(label, fns, want, nbytes, ops_per, lib=lib, share_fn=exact,
              rate=cs.FP32_FLOP_PER_S, kernel=label.split()[0])

    def library_unpack(q, s, want):
        """``torch.mul`` of the int8 blocks by their scales into a tensor
        of want's dtype, held to want's bits: the unpack in one call."""
        qb, sb = q.view(*s.shape, -1), s.unsqueeze(-1)
        out = torch.empty(qb.shape, dtype=want.dtype, device="cuda")
        torch.mul(qb, sb, out=out)
        cs.check(cs.bits_equal(torch, out.view(want.shape), want),
                 "qdma_unpack: torch.mul differs from the plain version")
        return lambda: torch.mul(qb, sb, out=out)

    qwen = make_run_config("qwen3-0.6b", "decode_32k").model
    leaves = cs.qdma_leaves(torch, qwen)
    B = cs.QDMA_BLOCK
    for shape, x in leaves.items():
        n, R = x.numel(), x.numel() // x.shape[-1]
        for block in (B, 256) if x.shape[-1] % 256 == 0 else (B,):
            row(f"qdma_pack {shape}, block {block}",
                {"old": lambda: old_pack(x, 0, R, block, x.shape),
                 "new": lambda: ops.qdma_pack(x, block=block)},
                ops.qdma_pack(x, block=block, backend="ref"),
                n * x.element_size() + n + n // block * 4, cs.PACK_OPS * n)
        q, s = ops.qdma_pack(x, block=B)
        outs = [torch.empty_like(x) for _ in "on"]
        want = ops.qdma_unpack(q, s, dtype=x.dtype, backend="ref")
        row(f"qdma_unpack {shape} -> {str(x.dtype)[6:]}",
            {"old": lambda: old_unpack(q, s, outs[0]),
             "new": lambda: ops.qdma_unpack(q, s, dtype=x.dtype,
                                            out=outs[1])},
            want, n * x.element_size() + n + s.numel() * 4,
            cs.UNPACK_OPS * n, lib=library_unpack(q, s, want))
        del q, s, outs, want
    x = next(iter(leaves.values()))
    (lo, hi), (rlo, rhi) = cs.qdma_descriptors(x)
    n = (hi - lo) * x.shape[-1]
    for block in (B, 256):
        row(f"qdma_pack_rows [{lo},{hi}) of the fp32 MLP leaf, block {block}",
            {"old": lambda: old_pack(x, lo, hi - lo, block),
             "new": lambda: ops.qdma_pack_rows(x, lo, rows=hi - lo,
                                               block=block)},
            ops.qdma_pack_rows(x, lo, rows=hi - lo, block=block,
                               backend="ref"),
            n * 5 + n // block * 4, cs.PACK_OPS * n)
    q, s = (row_view(t)[rlo:rhi] for t in ops.qdma_pack(x, block=B))
    dst = [row_view(torch.empty_like(x))[rlo:rhi] for _ in "on"]
    want = ops.qdma_unpack(q, s, backend="ref")
    row(f"qdma_unpack restore rows [{rlo},{rhi}) of the fp32 MLP leaf",
        {"old": lambda: old_unpack(q, s, dst[0]),
         "new": lambda: ops.qdma_unpack(q, s, out=dst[1])},
        want, q.numel() * 5 + s.numel() * 4, cs.UNPACK_OPS * q.numel(),
        lib=library_unpack(q, s, want))
    del leaves, x, q, s, dst, want
    g = torch.Generator(device="cuda").manual_seed(22)
    emb = torch.randn((qwen.vocab_size, qwen.d_model), generator=g,
                      device="cuda")
    nb = emb.numel() * 4
    row(f"qdma_digest fp32 embedding ({qwen.vocab_size},{qwen.d_model})",
        {"old": lambda: old_digest(emb), "new": lambda: ops.qdma_digest(emb)},
        ops.qdma_digest(emb, backend="ref"), nb + 8,
        cs.DIGEST_OPS_PER_BYTE * nb)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory holding the earlier sources of the "
                         "chosen kernels and common.cuh")
    ap.add_argument("--kernels", nargs="+", choices=sorted(GROUPS),
                    default=sorted(GROUPS))
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attn_same_call: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for group in ALONE:
        if group in args.kernels and len(args.kernels) > 1:
            ap.error(f"--kernels {group} compares against another revision: "
                     "run it alone")
    # fp32 products in full fp32 (the plain versions' einsums, SDPA)
    torch.backends.cuda.matmul.allow_tf32 = False
    stems = [s for g in args.kernels for s in GROUPS[g]]
    build.build(stems)
    for stem in stems:
        ptxas(build.library_path(stem).with_suffix(".log").read_text(),
              f"new {stem}")
    old = build_old(args.old, stems, ALONE.get(args.kernels[0], OLD_ARGTYPES)
                    if len(args.kernels) == 1 else OLD_ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    turns = Turns(torch, cs, args.reps)
    one = torch.zeros(1, device="cuda")
    floor = turns.timer.ms(lambda: one.zero_(), reps=args.reps)
    print(f"the timer's floor, a one-float fill: {floor:.4f} ms", flush=True)
    if "attention" in args.kernels:
        time_attention(torch, cs, old, turns, stream)
    if "fp32" in args.kernels:
        time_fp32(torch, cs, old, turns, stream)
    if "paged_fp32" in args.kernels:
        time_paged_fp32(torch, cs, old, turns, stream, args.seed)
    if "decode_fp32" in args.kernels:
        time_decode_fp32(torch, cs, old, turns, stream)
    if "paged" in args.kernels:
        time_paged(torch, cs, old, turns, stream, args.seed)
    if "ssm" in args.kernels:
        time_ssm(torch, cs, old, turns, stream)
    if "sample" in args.kernels:
        time_sample(torch, cs, old, turns, stream)
    if "qdma" in args.kernels:
        time_qdma(torch, cs, old, turns, stream)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "attn_same_call.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "floor_ms": floor, "rows": turns.rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
