"""Dispatch wrappers for the port's CUDA kernels (mirrors
``repro.kernels.ops``).

The tensors' device picks the path, and callers never branch on it:

  CUDA tensor    the hand-written kernel (``csrc/``) launches, or the
                 wrapper raises: there is no fall back to the plain
                 version when a kernel fails to build, launch or accept
                 its inputs
  CPU tensor     the plain PyTorch version in ``kernels/ref.py``
  backend="ref"  the plain version on any device (``kernel_backend=
                 "reference"``; ``chip_smoke.py`` compares against it)

Each wrapper checks device, dtype, shape and contiguity before a launch,
raises on the error code the C function returns (``cudaGetLastError``
right after the launch), and counts its launches in ``LAUNCHES`` — a run
shows through these counts which kernels it went through.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.sampling import prepare_rows

#: launches per kernel since the last ``reset_launch_counts``
LAUNCHES = {"flash_attention": 0, "paged_decode": 0,
            "paged_decode_quant": 0, "fused_sample": 0}


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _plain(backend: str, x: torch.Tensor) -> bool:
    """True when the plain version runs: forced, or a CPU tensor."""
    if backend not in ("auto", "ref"):
        raise ValueError(f"backend {backend!r}: 'auto' or 'ref'")
    if backend == "ref" or x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernels for device {x.device}")
    return False


def _want(name: str, t: torch.Tensor, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(kernel: str, lib_name: str, fn: str, *args):
    lib = build.library(lib_name)
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.kernel_error_string(rc).decode()}")
    LAUNCHES[kernel] += 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = True, backend: str = "auto"):
    """q: (B,S,H,hd); k,v: (B,T,K,hd); H % K == 0. Returns (B,S,H,hd).
    The kernel takes bf16 and hd in (64, 128), any S and T."""
    if _plain(backend, q):
        return _ref.flash_attention_ref(q, k, v, causal=causal)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    dev = q.device
    if H % K or hd not in (64, 128):
        raise ValueError(f"flash_attention kernel: H={H}, K={K}, hd={hd}")
    _want("q", q, torch.bfloat16, (B, S, H, hd), dev)
    _want("k", k, torch.bfloat16, (B, T, K, hd), dev)
    _want("v", v, torch.bfloat16, (B, T, K, hd), dev)
    out = torch.empty_like(q)
    if out.numel():
        _launch("flash_attention", "flash_attention", "launch_flash_attention",
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, H, K, hd, int(causal), _stream(dev))
    return out


def _check_paged(q, k_pages, v_pages, tables, pos, dtype):
    B, _, H, hd = q.shape
    P, page, K = k_pages.shape[:3]
    dev = q.device
    if H % K:
        raise ValueError(f"paged_decode kernel: H={H}, K={K}")
    _want("q", q, torch.bfloat16, (B, 1, H, hd), dev)
    _want("k_pages", k_pages, dtype, (P, page, K, hd), dev)
    _want("v_pages", v_pages, dtype, (P, page, K, hd), dev)
    _want("tables", tables, torch.int32, (B, tables.shape[1]), dev)
    _want("pos", pos, torch.int32, (B,), dev)
    # the kernel reads pages 16 bytes at a time
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16 or \
            (hd * k_pages.element_size()) % 16:
        raise ValueError("paged_decode kernel: page rows must be 16-byte "
                         "aligned")
    return B, tables.shape[1], page, K, hd, H // K


def paged_decode(q, k_pages, v_pages, tables, pos, *, backend: str = "auto"):
    """q: (B,1,H,hd); k_pages,v_pages: (P,page,K,hd); tables: (B,NP) int32;
    pos: (B,) int32 — attend to logical indices <= pos[b] (< 0: none,
    exactly-zero output row). The kernel takes bf16 pages."""
    if _plain(backend, q):
        return _ref.paged_decode_ref(q, k_pages, v_pages, tables, pos)
    B, NP, page, K, hd, G = _check_paged(q, k_pages, v_pages, tables, pos,
                                         torch.bfloat16)
    out = torch.empty_like(q)
    if B:
        _launch("paged_decode", "paged_decode", "launch_paged_decode",
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                B, NP, page, K, hd, G, _stream(q.device))
    return out


def paged_decode_quant(q, k_pages, v_pages, k_scale, v_scale, tables, pos,
                       *, backend: str = "auto"):
    """paged_decode over an int8 page pool with per-(row,head) fp32 scales
    (P,page,K), dequantized in the kernel's shared memory."""
    if _plain(backend, q):
        return _ref.paged_decode_quant_ref(q, k_pages, v_pages, k_scale,
                                           v_scale, tables, pos)
    B, NP, page, K, hd, G = _check_paged(q, k_pages, v_pages, tables, pos,
                                         torch.int8)
    P = k_pages.shape[0]
    _want("k_scale", k_scale, torch.float32, (P, page, K), q.device)
    _want("v_scale", v_scale, torch.float32, (P, page, K), q.device)
    out = torch.empty_like(q)
    if B:
        _launch("paged_decode_quant", "paged_decode",
                "launch_paged_decode_quant",
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), tables.data_ptr(),
                pos.data_ptr(), out.data_ptr(),
                B, NP, page, K, hd, G, _stream(q.device))
    return out


def sample_rows(z, keys4, *, backend: str = "auto"):
    """The fused sampler's kernel part: z (B,Vp) float32 rows from
    ``prepare_rows``, keys4 (B,4) int32 (seed, rid, counter, noisy) ->
    (B,) int32 token ids."""
    if _plain(backend, z):
        return _ref.sample_rows_ref(z, keys4)
    B, V = z.shape
    _want("z", z, torch.float32, (B, V), z.device)
    _want("keys", keys4, torch.int32, (B, 4), z.device)
    out = torch.empty((B,), dtype=torch.int32, device=z.device)
    if B:
        _launch("fused_sample", "fused_sample", "launch_fused_sample",
                z.data_ptr(), keys4.data_ptr(), out.data_ptr(), B, V,
                _stream(z.device))
    return out


def fused_sample(logits, temp, top_k, keys, *, vocab_size: int,
                 backend: str = "auto"):
    """Temperature/top-k Gumbel sampling: (B, Vp) logits -> (B,) int32
    token ids, bit-identical to ServeEngine._sample (the host oracle) row
    by row. temp (B,) float32, top_k (B,) int32, keys (B, 3) int32 =
    (seed, rid, counter). The front half (``prepare_rows``) is plain
    torch on every device; the noise and the argmax are the kernel."""
    z, noisy = prepare_rows(logits, temp, top_k, vocab_size=vocab_size)
    keys4 = torch.cat([keys.to(device=z.device, dtype=torch.int32),
                       noisy.to(torch.int32)[:, None]], dim=1).contiguous()
    return sample_rows(z.contiguous(), keys4, backend=backend)
