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

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.sampling import prepare_rows

#: launches per kernel since the last ``reset_launch_counts``
LAUNCHES = {"flash_attention": 0, "flash_decode": 0, "paged_decode": 0,
            "paged_decode_quant": 0, "fused_sample": 0, "ssm_scan": 0,
            "qdma_pack": 0, "qdma_pack_rows": 0, "qdma_unpack": 0,
            "qdma_digest": 0}
# the staging engine launches from a thread pool (pipeline=False)
_COUNT_LOCK = threading.Lock()


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


def _no_autograd(kernel: str, *xs):
    """The CUDA kernels compute forward only: their outputs are written
    through raw pointers and carry no ``grad_fn``. Launching one while
    autograd records a graph over its inputs would drop their gradients
    without a word, so the wrapper refuses (training takes the plain
    versions: ``Model`` asks for ``backend="ref"`` while grad is on)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input "
            "requires grad; call it under torch.no_grad() or take the "
            "plain version (backend='ref')")


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


#: the attention kernels' input dtypes: bf16, or fp32 (a model at fp32
#: compute); q, k and v all one of them
ATTN_DTYPES = (torch.bfloat16, torch.float32)


def _attn_dtype(kernel: str, q: torch.Tensor):
    """q's dtype where the attention kernels take it (``_want`` then holds
    the other inputs to it), else ``TypeError``."""
    if q.dtype not in ATTN_DTYPES:
        raise TypeError(f"{kernel}: q is {q.dtype}, the kernel takes "
                        "torch.bfloat16 or torch.float32")
    return q.dtype


def _aligned(name: str, t: torch.Tensor):
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch(kernel: str, lib_name: str, fn: str, *args):
    lib = build.library(lib_name)
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.kernel_error_string(rc).decode()}")
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
def check_flash_attention(q, k, v):
    """The flash_attention kernel's contract, checked before each launch
    (and by the dry-run before it counts the kernel's work)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    dev = q.device
    _no_autograd("flash_attention", q, k, v)
    if H % K or hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"flash_attention kernel: H={H}, K={K}, hd={hd}")
    dt = _attn_dtype("flash_attention", q)
    _want("q", q, dt, (B, S, H, hd), dev)
    _want("k", k, dt, (B, T, K, hd), dev)
    _want("v", v, dt, (B, T, K, hd), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _aligned(name, t)           # the kernel copies rows 16 bytes at a time


#: launch_flash_attention's ``block`` argument: FLASH_ATTENTION_AUTO lets
#: the launcher choose (the wrapper's call). A forced value means one thing
#: for each dtype: query heads a block of one KV group for bf16
#: (FLASH_ATTENTION_BF16_HEADS), query rows a block for fp32
#: (FLASH_ATTENTION_FP32_ROWS)
FLASH_ATTENTION_AUTO = 0
FLASH_ATTENTION_BF16_HEADS = (1, 2)
FLASH_ATTENTION_FP32_ROWS = (32, 64)


def flash_attention(q, k, v, *, causal: bool = True, backend: str = "auto"):
    """q: (B,S,H,hd); k,v: (B,T,K,hd); H % K == 0. Returns (B,S,H,hd) in
    q's dtype. The kernel takes q, k and v all bf16 or all fp32 (fp32 on
    the tensor cores as 3xTF32 products, within JAX's fp32 tolerance),
    any S and T, and any hd that is a multiple of 8 up to 128: its tiles
    are at most 128 columns wide, and it stages rows in 16-byte chunks,
    zero-filling the columns at or past hd."""
    if _plain(backend, q):
        return _ref.flash_attention_ref(q, k, v, causal=causal)
    check_flash_attention(q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty_like(q)
    if out.numel():
        _launch("flash_attention", "flash_attention", "launch_flash_attention",
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, H, K, hd, int(causal), FLASH_ATTENTION_AUTO,
                int(q.dtype == torch.float32), _stream(dev))
    return out


#: cache rows per block of the flash_decode kernel: two 64-row tiles in
#: flight at once; 128 blocks at pos 511 of a 1,024-row cache for B=4 and
#: 8 KV heads. A (slot, KV head)'s splits form one thread block cluster of
#: at most FLASH_DECODE_MAX_SPLITS blocks, so a longer cache gets longer
#: splits.
FLASH_DECODE_SPLIT = 128
FLASH_DECODE_MAX_SPLITS = 8
#: the Pallas flash_decode's default tile: the reference asserts
#: T % min(FLASH_DECODE_TILE, T) == 0, and the port keeps that contract
FLASH_DECODE_TILE = 256


def check_decode_call(k, pos):
    """flash_decode's contract on either path: the tile rule and a scalar
    position."""
    T = k.shape[1]
    bk = min(FLASH_DECODE_TILE, T)
    if bk < 1 or T % bk:
        raise ValueError(f"flash_decode: cache length {T} is not a multiple "
                         f"of the tile min({FLASH_DECODE_TILE}, T) = {bk}")
    if isinstance(pos, torch.Tensor) and pos.dim() != 0:
        raise ValueError(f"flash_decode: pos must be a scalar, got shape "
                         f"{tuple(pos.shape)}")


def check_flash_decode(q, k, v):
    """The flash_decode kernel's contract, checked before each launch
    (and by the dry-run before it counts the kernel's work)."""
    B, _, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    dev = q.device
    if H % K or hd % 8:
        raise ValueError(f"flash_decode kernel: H={H}, K={K}, hd={hd}")
    dt = _attn_dtype("flash_decode", q)
    _want("q", q, dt, (B, 1, H, hd), dev)
    _want("k", k, dt, (B, T, K, hd), dev)
    _want("v", v, dt, (B, T, K, hd), dev)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _aligned(name, t)           # the kernel copies rows 16 bytes at a time


def flash_decode(q, k, v, pos, *, backend: str = "auto"):
    """q: (B,1,H,hd); k,v: (B,T,K,hd); pos: scalar int or 0-d integer
    tensor, one position for the whole batch — attend to indices <= pos.
    T must be a multiple of min(FLASH_DECODE_TILE, T), the reference
    kernel's tile rule. The kernel takes q, k and v all bf16 or all fp32,
    hd % 8 == 0 (at most 256) and H / K <= 8; the output has q's dtype.
    An int position is a kernel argument; a tensor one (int32 or int64 on
    the device) is read by the kernel: a call launches the one kernel and
    nothing else."""
    check_decode_call(k, pos)
    if _plain(backend, q):
        return _ref.flash_decode_ref(q, k, v, pos)
    check_flash_decode(q, k, v)
    B, _, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    dev = q.device
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=dev)
        if pos_t.dtype not in (torch.int32, torch.int64):
            pos_t = pos_t.to(torch.int32)
        pos_ptr, pos_val = pos_t.data_ptr(), 0
        pos_is64 = int(pos_t.dtype == torch.int64)
    else:
        # clamped to [-1, T-1] here, as the kernel clamps a read position
        pos_ptr, pos_val, pos_is64 = None, max(-1, min(int(pos), T - 1)), 0
    rows = max(FLASH_DECODE_SPLIT, -(-T // FLASH_DECODE_MAX_SPLITS))
    out = torch.empty_like(q)
    if B:
        _launch("flash_decode", "flash_decode", "launch_flash_decode",
                q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_ptr,
                out.data_ptr(), pos_val, pos_is64, B, T, K, hd, H // K, rows,
                int(q.dtype == torch.float32), _stream(dev))
    return out


def check_ssm_chunk(S: int, chunk: int) -> int:
    """The chunk length Q = min(chunk, S); the scan (the Pallas kernel and
    ``ssd_chunked`` alike) needs S % Q == 0. Padding the sequence instead
    would integrate the pad tokens into the recurrent state."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(
            f"ssm_scan: sequence length {S} breaks the chunk rule "
            f"S % min(chunk, S) == 0 (chunk {chunk}): a prompt must be at "
            f"most {chunk} tokens or a multiple of {chunk}")
    return Q


def ssm_scan(xdt, Bv, Cv, log_a, *, chunk: int = 128, backend: str = "auto"):
    """The chunked SSD scan: xdt (B,S,H,hd), Bv/Cv (B,S,N), log_a (B,S,H)
    fp32 -> (y (B,S,H,hd) fp32, final state (B,H,hd,N) fp32). S must be a
    multiple of Q = min(chunk, S) (``ValueError`` otherwise). The kernel
    takes xdt, Bv and Cv all bf16 or all fp32, Q <= 128, hd <= 64 and
    N <= 128."""
    B, S, H, hd = xdt.shape
    N = Bv.shape[-1]
    Q = check_ssm_chunk(S, chunk)
    if _plain(backend, xdt):
        return _ref.ssm_scan_ref(xdt, Bv, Cv, log_a, chunk=chunk)
    dev = xdt.device
    _no_autograd("ssm_scan", xdt, Bv, Cv, log_a)
    if xdt.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ssm_scan kernel takes bf16 or fp32, not "
                        f"{xdt.dtype}")
    _want("xdt", xdt, xdt.dtype, (B, S, H, hd), dev)
    _want("Bv", Bv, xdt.dtype, (B, S, N), dev)
    _want("Cv", Cv, xdt.dtype, (B, S, N), dev)
    _want("log_a", log_a, torch.float32, (B, S, H), dev)
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    state = torch.empty((B, H, hd, N), dtype=torch.float32, device=dev)
    if y.numel():
        _launch("ssm_scan", "ssm_scan", "launch_ssm_scan",
                xdt.data_ptr(), Bv.data_ptr(), Cv.data_ptr(),
                log_a.data_ptr(), y.data_ptr(), state.data_ptr(),
                B, S, H, hd, N, Q, int(xdt.dtype == torch.bfloat16),
                _stream(dev))
    return y, state


def _check_paged(q, k_pages, v_pages, tables, pos, dtype):
    """The paged kernels' contract: q bf16 or fp32, the pages ``dtype``
    (q's, or int8 for the quantized kernel)."""
    B, _, H, hd = q.shape
    P, page, K = k_pages.shape[:3]
    dev = q.device
    if H % K:
        raise ValueError(f"paged_decode kernel: H={H}, K={K}")
    _want("q", q, _attn_dtype("paged_decode", q), (B, 1, H, hd), dev)
    _want("k_pages", k_pages, dtype, (P, page, K, hd), dev)
    _want("v_pages", v_pages, dtype, (P, page, K, hd), dev)
    _want("tables", tables, torch.int32, (B, tables.shape[1]), dev)
    _want("pos", pos, torch.int32, (B,), dev)
    # the kernel reads pages 16 bytes at a time, q 4 bytes at a time
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        _aligned(name, t)
    if (hd * k_pages.element_size()) % 16:
        raise ValueError("paged_decode kernel: page rows must be 16-byte "
                         "aligned")
    return B, tables.shape[1], page, K, hd, H // K


def paged_decode(q, k_pages, v_pages, tables, pos, *, backend: str = "auto"):
    """q: (B,1,H,hd); k_pages,v_pages: (P,page,K,hd); tables: (B,NP) int32;
    pos: (B,) int32 — attend to logical indices <= pos[b] (< 0: none,
    exactly-zero output row). The kernel takes q and the pages all bf16 or
    all fp32, H / K <= 8 and hd <= 256, and reads tables and pos on the
    card: a call launches the one kernel and never waits on the host."""
    if _plain(backend, q):
        return _ref.paged_decode_ref(q, k_pages, v_pages, tables, pos)
    B, NP, page, K, hd, G = _check_paged(q, k_pages, v_pages, tables, pos,
                                         q.dtype)
    out = torch.empty_like(q)
    if B:
        _launch("paged_decode", "paged_decode", "launch_paged_decode",
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                B, NP, page, K, hd, G, int(q.dtype == torch.float32),
                _stream(q.device))
    return out


def paged_decode_quant(q, k_pages, v_pages, k_scale, v_scale, tables, pos,
                       *, backend: str = "auto"):
    """paged_decode over an int8 page pool with per-(row,head) fp32 scales
    (P,page,K); q bf16 or fp32, the output in q's dtype. The kernel reads
    the pages at int8 width, widens them exactly (to bf16 for the tensor
    cores under bf16 q, to fp32 under fp32 q) and applies the scales in
    fp32: the k scale to the score, the v scale to the probability."""
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
                B, NP, page, K, hd, G, int(q.dtype == torch.float32),
                _stream(q.device))
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


# ---------------------------------------------------------------------------
# the staging engine's kernels (qdma_pack.cu)
# ---------------------------------------------------------------------------
#: dtypes the pack kernel reads and the unpack kernel writes (bf16 flag)
_QDMA_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("float32",
    "bfloat16"; the names the JAX package stores in a QuantizedLeaf)."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def _pack_launch(kernel: str, x, lo: int, rows: int, block: int):
    """Launch the pack kernel on rows [lo, lo+rows) of x's row view:
    the pointer is offset, nothing is sliced or copied."""
    if x.dtype not in _QDMA_TYPES:
        raise TypeError(f"{kernel} kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    L = x.shape[-1] if x.dim() else 1
    # the group's byte size is checked by launch_qdma_pack (invalid
    # argument), which knows what fits the kernel's registers
    if block < 1 or L % block:
        raise ValueError(f"{kernel} kernel: block {block} does not divide "
                         f"the last dim {L}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: x must be contiguous")
    _aligned("x", x)
    R = x.numel() // L
    if lo < 0 or rows < 0 or lo + rows > R:
        raise ValueError(f"{kernel}: rows [{lo}, {lo + rows}) outside "
                         f"the {R} rows of x")
    q = torch.empty((rows, L), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, L // block), dtype=torch.float32,
                        device=x.device)
    if rows:
        _launch(kernel, "qdma_pack", "launch_qdma_pack",
                x.data_ptr() + lo * L * x.element_size(), q.data_ptr(),
                scale.data_ptr(), rows * (L // block), block,
                _QDMA_TYPES[x.dtype], _stream(x.device))
    return q, scale


def qdma_pack(x, *, block: int = 256, backend: str = "auto"):
    """Blockwise symmetric int8 over the last dim: x (..., L) float32 or
    bfloat16, L % block == 0 -> (q int8 (..., L), scale float32
    (..., L/block))."""
    if _plain(backend, x):
        return _ref.qdma_pack_ref(x, block=block)
    L = x.shape[-1]
    q, scale = _pack_launch("qdma_pack", x, 0, x.numel() // L, block)
    return q.reshape(x.shape), scale.reshape(x.shape[:-1] + (L // block,))


def qdma_pack_rows(x, lo: int, *, rows: int, block: int = 256,
                   backend: str = "auto"):
    """Pack ONE descriptor: rows [lo, lo+rows) of the 2-D row view of x.
    Returns (q (rows, L) int8, scale (rows, L/block) float32)."""
    if _plain(backend, x):
        return _ref.qdma_pack_rows_ref(x, lo, rows, block=block)
    return _pack_launch("qdma_pack_rows", x, int(lo), int(rows), block)


def qdma_unpack(q, scale, *, dtype=torch.float32, out=None,
                backend: str = "auto"):
    """Inverse of qdma_pack: ``q * scale`` per block, cast to ``dtype``
    (float32 or bfloat16, or their names). ``out``, where given, is a
    contiguous tensor of q's element count that receives the result."""
    dtype = as_dtype(dtype)
    if _plain(backend, q):
        x = _ref.qdma_unpack_ref(q, scale, dtype=dtype)
        return x if out is None else out.copy_(x.reshape(out.shape))
    L, nb = q.shape[-1], scale.shape[-1]
    block = L // max(nb, 1)
    dev = q.device
    if dtype not in _QDMA_TYPES:
        raise TypeError(f"qdma_unpack kernel writes float32 or bfloat16, "
                        f"not {dtype}")
    if nb < 1 or L % nb or block % 16:
        raise ValueError(f"qdma_unpack kernel: {nb} scales over last dim "
                         f"{L} (the block must be a multiple of 16)")
    _want("q", q, torch.int8, q.shape, dev)
    _want("scale", scale, torch.float32, q.shape[:-1] + (nb,), dev)
    if out is None:
        out = torch.empty(q.shape, dtype=dtype, device=dev)
    _want("out", out, dtype, out.shape, dev)
    if out.numel() != q.numel():
        raise ValueError(f"out holds {out.numel()} values, q {q.numel()}")
    _aligned("q", q)
    _aligned("out", out)
    if q.numel():
        _launch("qdma_unpack", "qdma_pack", "launch_qdma_unpack",
                q.data_ptr(), scale.data_ptr(), out.data_ptr(), q.numel(),
                block, _QDMA_TYPES[dtype], _stream(dev))
    return out


def qdma_digest(x, *, backend: str = "auto"):
    """Content fingerprint of x's raw bytes (any dtype, any size): (2,)
    int64 holding two uint32 words. Equal bytes give equal digests; the
    weights depend on the byte's position, so permutations do not."""
    if _plain(backend, x):
        return _ref.qdma_digest_ref(x)
    u = _ref.bytes_view(x)
    if u.data_ptr() % 16:
        u = u.clone()                 # a view at an odd offset: realign
    out = torch.zeros((2,), dtype=torch.int32, device=x.device)
    if u.numel():
        _launch("qdma_digest", "qdma_pack", "launch_qdma_digest",
                u.data_ptr(), u.numel(), out.data_ptr(), _stream(x.device))
    return out.to(torch.int64) & 0xFFFFFFFF
