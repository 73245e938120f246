"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, a true per-token recurrence); mirrors
``repro.models.xlstm``.

mLSTM semantics (per head, stabilized — xLSTM paper eq. 19-27):
  C_t = f_t C_{t-1} + i_t k_t v_t^T      n_t = f_t n_{t-1} + i_t k_t
  h_t = (q_t·C_t) / max(|q_t·n_t|, exp(-m_t))
with exponential gates stabilized by the running max m_t. The chunkwise
form processes Q-token chunks with intra-chunk pairwise decays and a
sequential (max-coupled) carry across chunks, a Python loop over the
chunks where JAX scans them. A sequence must be at most one chunk or a
multiple of it (``check_mlstm_chunk``): the port never pads, since pad
tokens would enter the recurrent state.

sLSTM keeps a per-channel scalar memory with block-diagonal (per-head)
recurrent weights. The hidden state feeds the gates, so it runs as a
Python loop over the tokens (JAX's ``lax.scan``), a handful of small
kernels per token on a card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import mlstm_dims

NEG = -1e30
SLSTM_M0 = -30.0      # a fresh sLSTM carry's stabilizer


def check_mlstm_chunk(S: int, chunk: int) -> int:
    """The chunk length Q = min(chunk, S); the chunkwise mLSTM needs
    S % Q == 0."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(
            f"mlstm_chunked: sequence length {S} breaks the chunk rule "
            f"S % min(chunk, S) == 0 (chunk {chunk}): a prompt must be at "
            f"most {chunk} tokens or a multiple of {chunk}")
    return Q


# ===========================================================================
# mLSTM
# ===========================================================================
def mlstm_chunked(q, k, v, log_f, log_i, state=None, chunk: int = 128):
    """q,k,v: (B,S,H,hd); log_f, log_i: (B,S,H) fp32.

    Returns h (B,S,H,hd) fp32 and the final state dict(C,n,m)."""
    B, S, H, hd = q.shape
    Q = check_mlstm_chunk(S, chunk)
    nc = S // Q
    f32 = torch.float32
    q = q.to(f32) / math.sqrt(hd)
    k = k.to(f32)
    v = v.to(f32)
    lf = log_f.to(f32).reshape(B, nc, Q, H)
    li = log_i.to(f32).reshape(B, nc, Q, H)
    qc = q.reshape(B, nc, Q, H, hd)
    kc = k.reshape(B, nc, Q, H, hd)
    vc = v.reshape(B, nc, Q, H, hd)

    F_ = torch.cumsum(lf, dim=2)                               # (B,nc,Q,H)
    if state is None:
        Cp = torch.zeros((B, H, hd, hd), dtype=f32, device=q.device)
        np_ = torch.zeros((B, H, hd), dtype=f32, device=q.device)
        mp = torch.full((B, H), NEG, dtype=f32, device=q.device)
    else:
        Cp, np_, mp = state["C"], state["n"], state["m"]

    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    hs = []
    for c in range(nc):
        qq, kk, vv = qc[:, c], kc[:, c], vc[:, c]              # (B,Q,H,hd)
        Ft = F_[:, c].transpose(1, 2)                          # (B,H,Q)
        lit = li[:, c].transpose(1, 2)
        # pairwise D_ts = F_t - F_s + log_i_s  (s <= t)
        Dm = Ft[..., :, None] - Ft[..., None, :] + lit[..., None, :]
        Dm = torch.where(mask, Dm, torch.full_like(Dm, NEG))   # (B,H,Q,Q)
        m_intra = Dm.amax(dim=-1)                              # (B,H,Q)
        m_inter = Ft + mp[..., None]                           # (B,H,Q)
        m_t = torch.maximum(m_intra, m_inter)
        Sm = torch.exp(Dm - m_t[..., None])                    # (B,H,Q,Q)
        c_t = torch.exp(m_inter - m_t)                         # (B,H,Q)
        qkT = torch.einsum("bqhd,bshd->bhqs", qq, kk)
        A = qkT * Sm
        num = torch.einsum("bhqs,bshd->bqhd", A, vv) + \
            c_t.transpose(1, 2)[..., None] * \
            torch.einsum("bqhd,bhde->bqhe", qq, Cp)
        den = A.sum(-1).transpose(1, 2) + \
            c_t.transpose(1, 2) * torch.einsum("bqhd,bhd->bqh", qq, np_)
        h = num / torch.maximum(den.abs(),
                                torch.exp(-m_t).transpose(1, 2))[..., None]
        hs.append(h)
        # end-of-chunk state
        Fl = Ft[..., -1]                                       # (B,H)
        w = Fl[..., None] - Ft + lit                           # (B,H,Q)
        m_state = torch.maximum(Fl + mp, w.amax(dim=-1))
        wS = torch.exp(w - m_state[..., None])                 # (B,H,Q)
        decay = torch.exp(Fl + mp - m_state)
        Cp = decay[..., None, None] * Cp + \
            torch.einsum("bhq,bqhd,bqhe->bhde", wS, kk, vv)
        np_ = decay[..., None] * np_ + torch.einsum("bhq,bqhd->bhd", wS, kk)
        mp = m_state
    h = torch.stack(hs, dim=1).reshape(B, S, H, hd)
    return h, {"C": Cp, "n": np_, "m": mp}


def mlstm_step(q, k, v, log_f, log_i, state):
    """Single decode step. q,k,v: (B,H,hd); log_f/log_i: (B,H)."""
    hd = q.shape[-1]
    f32 = torch.float32
    q = q.to(f32) / math.sqrt(hd)
    k = k.to(f32)
    v = v.to(f32)
    Cp, np_, mp = state["C"], state["n"], state["m"]
    m_t = torch.maximum(log_f + mp, log_i)
    f = torch.exp(log_f + mp - m_t)
    i = torch.exp(log_i - m_t)
    Cn = f[..., None, None] * Cp + i[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", k, v)
    nn_ = f[..., None] * np_ + i[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, Cn)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, nn_).abs(),
                        torch.exp(-m_t))
    h = num / den[..., None]
    return h, {"C": Cn, "n": nn_, "m": m_t}


def mlstm_block(cfg: ModelConfig, p: dict, x, cdt, mode: str = "train",
                cache: dict | None = None, **_):
    """x: (B,S,D). Returns (out, new_cache): {"mlstm": {C, n, m}} in
    prefill and decode (decode reads the old state from ``cache``; its
    caller writes the new one in place), None in train mode."""
    di, H = mlstm_dims(cfg)
    hd = cfg.xlstm.head_dim
    B, S, D = x.shape
    f32 = torch.float32
    h = rms_norm(x, p["ln"], cfg.norm_eps).to(cdt)
    up = h @ p["w_up"].to(cdt)
    xm, z = up[..., :di], up[..., di:]
    q = (xm @ p["wq"].to(cdt)).reshape(B, S, H, hd)
    k = (xm @ p["wk"].to(cdt)).reshape(B, S, H, hd)
    v = (xm @ p["wv"].to(cdt)).reshape(B, S, H, hd)
    xf = xm.to(f32)
    log_f = F.logsigmoid(xf @ p["w_f"].to(f32) + p["b_f"].to(f32))
    log_i = xf @ p["w_i"].to(f32) + p["b_i"].to(f32)           # (B,S,H)

    state = cache.get("mlstm") if cache else None
    if mode == "decode":
        y, new_state = mlstm_step(q[:, 0], k[:, 0], v[:, 0],
                                  log_f[:, 0], log_i[:, 0], state)
        y = y[:, None]
    else:
        y, new_state = mlstm_chunked(q, k, v, log_f, log_i, state,
                                     chunk=cfg.xlstm.chunk)
    y = y.reshape(B, S, di)
    y = rms_norm(y.to(cdt), p["norm"], cfg.norm_eps)
    y = y.to(f32) * F.silu(z.to(f32))
    out = y.to(cdt) @ p["w_out"].to(cdt)
    new_cache = {"mlstm": new_state} if mode in ("prefill", "decode") else None
    return out, new_cache


# ===========================================================================
# sLSTM
# ===========================================================================
def slstm_scan(zx, ix, fx, ox, r, bias, state):
    """The sLSTM recurrence over the tokens: zx, ix, fx, ox (B,S,D) fp32
    input projections, r (4,heads,dh,dh) the z/i/f/o recurrent weights,
    bias their four (D,) biases, state (h, c, n, m) each (B,D) fp32.
    Returns (y (B,S,D), the final state)."""
    B, S, D = zx.shape
    heads, dh = r.shape[1], r.shape[2]
    bz, bi, bf, bo = bias
    hp, cp, npr, mp = state
    hs = []
    for t in range(S):
        rz, ri, rf, ro = torch.einsum(
            "bhd,ghde->gbhe", hp.reshape(B, heads, dh), r).reshape(4, B, D)
        z = torch.tanh(zx[:, t] + rz + bz)
        li = ix[:, t] + ri + bi
        lf = F.logsigmoid(fx[:, t] + rf + bf)
        m = torch.maximum(lf + mp, li)
        i = torch.exp(li - m)
        f = torch.exp(lf + mp - m)
        cp = f * cp + i * z
        npr = f * npr + i
        o = torch.sigmoid(ox[:, t] + ro + bo)
        hp = o * cp / torch.clamp(npr, min=1e-6)
        mp = m
        hs.append(hp)
    return torch.stack(hs, dim=1), (hp, cp, npr, mp)


def slstm_block(cfg: ModelConfig, p: dict, x, cdt, mode: str = "train",
                cache: dict | None = None, **_):
    """x: (B,S,D). Returns (out, new_cache): {"slstm": {h, c, n, m}} fp32
    in prefill and decode, None in train mode. A fresh carry is zeros with
    m = ``SLSTM_M0``; decode (and a cache given to any mode) continues
    from ``cache["slstm"]``."""
    B, S, D = x.shape
    f32 = torch.float32
    xin = rms_norm(x, p["ln"], cfg.norm_eps).to(cdt)
    # input projections for all tokens up front (the parallel part)
    zx, ix, fx, ox = ((xin @ p[f"w_{g}"].to(cdt)).to(f32) for g in "zifo")

    if cache and "slstm" in cache:
        st = cache["slstm"]
        state = (st["h"], st["c"], st["n"], st["m"])
    else:
        hp = torch.zeros((B, D), dtype=f32, device=x.device)
        state = (hp, torch.zeros_like(hp), torch.zeros_like(hp),
                 torch.full((B, D), SLSTM_M0, dtype=f32, device=x.device))

    # the four block-diagonal recurrent matmuls of a token as one einsum
    r = torch.stack([p[f"r_{g}"].to(f32) for g in "zifo"])  # (4,heads,dh,dh)
    bias = tuple(p[f"b_{g}"].to(f32) for g in "zifo")
    y, (hp, cp, npr, mp) = slstm_scan(zx, ix, fx, ox, r, bias, state)
    y = rms_norm(y.to(cdt), p["norm"], cfg.norm_eps).to(cdt)
    # GLU up/down
    g = F.silu((y @ p["up_wg"].to(cdt)).to(f32))
    u = (y @ p["up_wi"].to(cdt)).to(f32)
    out = (g * u).to(cdt) @ p["up_wo"].to(cdt)
    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"slstm": {"h": hp, "c": cp, "n": npr, "m": mp}}
    return out, new_cache
