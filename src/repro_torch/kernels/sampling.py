"""Fused temperature/top-k Gumbel sampling: the noise and the sampler's
front half, shared by the host oracle, the plain version and the kernel.

Bit-identity contract (invariant I10). ``ServeEngine._sample`` is the
host-side oracle: a request's token t must be the same whether it was
sampled on the host or on the card, before or after a pause. So every
step here is portably exact (a copy of ``repro.kernels.sampling``, which
the port may not import):

  noise      a counter-seeded uint32 hash of (seed, rid, token_counter,
             vocab_index) with wrapping arithmetic
  u32 -> u   ``((h >> 8) + 0.5) * 2^-24``, exact in float32, u in (0, 1)
  gumbel     ``-log(-log(u))`` with ``log`` built here from exponent
             extraction and an atanh polynomial over correctly rounded
             float32 +, -, *, / only
  argmax     the first index of the maximum

Three instantiations draw the same bits: numpy (``host_gumbel``, what
``ServeEngine._sample`` adds), torch (``torch_gumbel``, inside the plain
version ``kernels.ref.sample_rows_ref``) and CUDA C++
(``kernels/csrc/fused_sample.cu``, built without FMA contraction).
Torch has no logical ``>>`` on uint32 and its int32 ``>>`` is
arithmetic, so the torch twin carries the uint32 words in int64 and
masks with ``0xFFFFFFFF`` after every step that can leave 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

# uint32 avalanche constants (splitmix/murmur-style finalizer)
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLD = 0x9E3779B9
_SALT = 0x5E12C0DE     # the serve plane's sampling-stream domain tag

# portable-log constants (float32 exact values)
_LN2 = np.float32(0.6931471805599453)
_SQRT2 = np.float32(1.4142135623730951)
_C3 = np.float32(1.0 / 3.0)
_C5 = np.float32(1.0 / 5.0)
_C7 = np.float32(1.0 / 7.0)
_C9 = np.float32(1.0 / 9.0)
_HALF = np.float32(0.5)
_ONE = np.float32(1.0)
_TWO = np.float32(2.0)
_U24 = np.float32(2.0 ** -24)


# ---------------------------------------------------------------------------
# numpy instantiation (the host oracle's noise source)
# ---------------------------------------------------------------------------
def _mix(h, xp):
    """Finalizing avalanche mix over uint32 (wrapping arithmetic)."""
    h = h ^ (h >> 16)
    h = h * xp.uint32(_M1)
    h = h ^ (h >> 15)
    h = h * xp.uint32(_M2)
    h = h ^ (h >> 16)
    return h


def _log32(x, xp, to_i32, to_f32):
    """Portable float32 natural log for x > 0 (normal range).

    Exponent/mantissa split via bitcast, then ln(m) from the atanh series
    2s(1 + s^2/3 + s^4/5 + ...) with s = (m-1)/(m+1), |s| < 0.1716 after
    centering m into [sqrt(2)/2, sqrt(2)). Only +,-,*,/ on float32 — all
    correctly rounded, so every instantiation produces identical bits.
    """
    bits = to_i32(x)
    e = ((bits >> 23) & 0xFF) - 127
    m = to_f32((bits & 0x007FFFFF) | 0x3F800000)          # [1, 2)
    big = m > _SQRT2
    m = xp.where(big, m * _HALF, m)
    e = xp.where(big, e + 1, e)
    s = (m - _ONE) / (m + _ONE)
    t = s * s
    poly = _ONE + t * (_C3 + t * (_C5 + t * (_C7 + t * _C9)))
    return e.astype(xp.float32) * _LN2 + (_TWO * s) * poly


def _gumbel(base_u32, idx_u32, xp, to_i32, to_f32):
    """Gumbel(0,1) noise for each vocab index, from the mixed base key."""
    h = _mix(base_u32 ^ idx_u32, xp)
    u = (((h >> 8)).astype(xp.float32) + _HALF) * _U24    # (0,1) exclusive
    return -_log32(-_log32(u, xp, to_i32, to_f32), xp, to_i32, to_f32)


def _base_key(seed, rid, counter, xp):
    """Counter-seeded stream key: token ``counter`` of request
    (seed, rid) always derives the same key — sampling stays a pure
    function of the request, which is what makes pause/replay
    token-identical (I10)."""
    h = _mix(xp.uint32(_SALT) ^ (seed.astype(xp.uint32) * xp.uint32(_GOLD)),
             xp)
    h = _mix(h ^ rid.astype(xp.uint32), xp)
    h = _mix(h ^ counter.astype(xp.uint32), xp)
    return h


def _np_to_i32(x):
    return np.ascontiguousarray(x).view(np.int32)


def _np_to_f32(x):
    return np.ascontiguousarray(x).astype(np.uint32).view(np.float32) \
        if x.dtype != np.int32 else np.ascontiguousarray(x).view(np.float32)


def host_gumbel(seed: int, rid: int, counter: int, n: int) -> np.ndarray:
    """(n,) float32 Gumbel noise for token ``counter`` of request
    (seed, rid) — numpy twin of the on-card draw, bit-identical."""
    base = _base_key(np.uint32(np.asarray([seed], np.int64) & 0xFFFFFFFF),
                     np.uint32(np.asarray([rid], np.int64) & 0xFFFFFFFF),
                     np.uint32(np.asarray([counter],
                                          np.int64) & 0xFFFFFFFF), np)
    idx = np.arange(n, dtype=np.uint32)
    return _gumbel(base, idx, np, _np_to_i32, _np_to_f32)


# ---------------------------------------------------------------------------
# torch instantiation (uint32 words carried in int64)
# ---------------------------------------------------------------------------
_U32 = 0xFFFFFFFF


def _mul_u32(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32): split c in 16-bit halves so
    no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix_t(h):
    h = h ^ (h >> 16)
    h = _mul_u32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul_u32(h, _M2)
    return h ^ (h >> 16)


def _log32_t(x):
    """Torch twin of ``_log32`` (float32 in, float32 out)."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m > float(_SQRT2)
    m = torch.where(big, m * float(_HALF), m)
    e = torch.where(big, e + 1, e)
    s = (m - float(_ONE)) / (m + float(_ONE))
    t = s * s
    poly = float(_ONE) + t * (float(_C3) + t * (float(_C5) + t * (
        float(_C7) + t * float(_C9))))
    return e.to(torch.float32) * float(_LN2) + (float(_TWO) * s) * poly


def torch_base_key(keys):
    """keys: (..., 3+) int32 (seed, rid, counter, ...) -> (...) int64
    holding the uint32 stream key."""
    k = keys.to(torch.int64) & _U32
    h = _mix_t(_SALT ^ _mul_u32(k[..., 0], _GOLD))
    h = _mix_t(h ^ k[..., 1])
    return _mix_t(h ^ k[..., 2])


def torch_gumbel(keys, idx):
    """keys: (B, 3+) int32; idx: (V,) int64 vocab indices. Returns (B, V)
    float32 noise, bit-identical to ``host_gumbel`` row by row."""
    h = _mix_t(torch_base_key(keys)[:, None] ^ idx[None, :])
    u = ((h >> 8).to(torch.float32) + float(_HALF)) * float(_U24)
    return -_log32_t(-_log32_t(u))


# ---------------------------------------------------------------------------
# the sampler's front half (plain torch on every device, as it is plain
# XLA in the JAX package)
# ---------------------------------------------------------------------------
def prepare_rows(logits, temp, top_k, *, vocab_size: int):
    """Cast to float32, mask the padded vocab tail, temperature-scale,
    top-k filter. Greedy rows (temp <= 0) pass through unscaled so the
    argmax equals the host's greedy ``argmax(logits)``. Returns (B, Vp)
    float32 rows ready for noise + argmax, plus the (B,) bool noisy-row
    mask."""
    B, Vp = logits.shape
    dev = logits.device
    lg = logits.to(torch.float32)
    vmask = torch.arange(Vp, device=dev) < vocab_size
    lg = lg.masked_fill(~vmask[None, :], -torch.inf)
    temp = temp.to(device=dev, dtype=torch.float32)
    noisy = temp > 0
    z = lg / torch.where(noisy, temp, torch.ones_like(temp))[:, None]
    # per-row k-th largest of the SCALED row (matches the host's
    # np.partition threshold); k outside (0, V) disables the filter
    top_k = top_k.to(device=dev, dtype=torch.int64)
    use_k = noisy & (top_k > 0) & (top_k < vocab_size)
    srt = torch.sort(z, dim=-1, descending=True).values
    kidx = (top_k - 1).clamp(0, Vp - 1)
    kth = srt.gather(1, kidx[:, None])[:, 0]
    thr = torch.where(use_k, kth, torch.full_like(kth, -torch.inf))
    z = torch.where(z >= thr[:, None], z, torch.full_like(z, -torch.inf))
    return z, noisy
