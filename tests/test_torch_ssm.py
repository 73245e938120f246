"""The port's hybrid Mamba-attention stack against the JAX package's, on
the same numpy inputs: the plain ``ssm_scan`` and ``flash_decode``
against JAX's Pallas kernels (interpret mode) and oracles,
``causal_conv1d``, ``mamba_block``, the hybrid model's prefill logits and
caches, prefill plus uniform-position decode against the teacher-forced
forward, the chunk rule, the param tree and interop. The model is the
smoke twin of ``jamba-1.5-large-398b-1p-dense`` (4 layers: one attention
and three mamba; d_model 64; SSM chunk 16, so every prompt is at most 16
tokens or a multiple of 16); on the JAX side it is the JAX smoke config
with ``moe=None``, built here.

Tolerances, each with its reason:
  ssm_scan vs Pallas      5e-5: both compute in fp32 from the same
                          (rounded) inputs, sums in other orders
  ssm_scan vs sequential  5e-4 (the JAX test's): the chunked and the
                          step-by-step recurrences round differently over
                          up to 64 steps
  flash_decode            fp32 2e-5 (sum order); bf16 2e-2, one bf16 step
                          at the outputs' magnitude (each side rounds its
                          fp32 result once)
  conv, mamba, model fp32 1e-4 on values of magnitude ~1: fp32 rounding in
                          other orders, amplified through the layers
  model bf16              5e-2 absolute: activations are rounded to bf16
                          after every matmul, and a value on a rounding
                          boundary can land one bf16 step apart; the JAX
                          side runs its Pallas kernels (interpret mode),
                          since its ``ssd_chunked`` rounds the decay-
                          weighted matrix and chunk states to bf16 and is
                          not the kernel's function
  decode vs forward       5% of max |logit| (tests/test_models.py's bound)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PrecisionConfig as JPrecision
from repro.configs import get_model_config as jax_model_config
from repro.configs import make_run_config as jax_run_config
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as pallas_decode
from repro.kernels.ssm_scan import ssm_scan as pallas_scan
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_model
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import get_model_config as torch_model_config
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models.model import build_model as torch_model
from repro_torch.tree import tree_items, tree_leaves

JAX_ARCH = "jamba-1.5-large-398b"
ARCH = "jamba-1.5-large-398b-1p-dense"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    """One float32 numpy array as a JAX and a torch array of ``dtype``
    (both round to nearest even, so the bits agree)."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a.copy()).to(TDT[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _runs(compute="float32", jax_backend="reference"):
    jrun = jax_run_config(JAX_ARCH, "decode_32k", smoke=True,
                          precision=JPrecision(compute=compute),
                          kernel_backend=jax_backend)
    jrun = dataclasses.replace(
        jrun, model=dataclasses.replace(jrun.model, moe=None))
    trun = torch_run_config(ARCH, "decode_32k", smoke=True,
                            precision=TPrecision(compute=compute))
    return jrun, trun


@pytest.fixture(scope="module")
def weights():
    jrun, _ = _runs()
    jp = jax_model(jrun).init(jax.random.key(0))
    return jp, interop.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


# ---------------------------------------------------------------------------
# ssm_scan
# ---------------------------------------------------------------------------
def _scan_inputs(seed, B, S, H, hd, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd), np.float32)
    b = rng.standard_normal((B, S, N), np.float32)
    c = rng.standard_normal((B, S, N), np.float32)
    la = -np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    return x, b, c, la


SCAN_SHAPES = [(2, 8, 3, 16, 16, 16),     # S < chunk: one chunk of 8
               (1, 64, 2, 32, 16, 16),    # four chunks
               (2, 48, 4, 16, 32, 16)]    # three chunks, N > hd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,hd,N,chunk", SCAN_SHAPES)
def test_ssm_scan_plain_matches_pallas(B, S, H, hd, N, chunk, dtype):
    x, b, c, la = _scan_inputs(S + H, B, S, H, hd, N)
    (xj, xt), (bj, bt), (cj, ct) = (_both(a, dtype) for a in (x, b, c))
    y, st = ops.ssm_scan(xt, bt, ct, torch.from_numpy(la), chunk=chunk)
    wy, wst = pallas_scan(xj, bj, cj, jnp.asarray(la), chunk=chunk,
                          interpret=True)
    assert y.dtype == st.dtype == torch.float32
    _close(y, wy, 5e-5)
    _close(st, wst, 5e-5)
    # the sequential oracle, in both packages, at the JAX test's bound
    sy, sst = tref.ssm_scan_sequential_ref(xt, bt, ct, torch.from_numpy(la))
    jy, jst = jref.ssm_scan_sequential_ref(xj, bj, cj, jnp.asarray(la))
    for got, want in ((y, sy), (st, sst), (sy, jy), (sst, jst)):
        _close(got, want, 5e-4)


def _bf16(t):
    return t.bfloat16().float()


def _pair(t):
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _mm(a, b, eq, form):
    """einsum(eq, a, b) as the tensor-core kernel forms it from fp32
    operands: each as a bf16 pair (hi hi + hi lo + lo hi, fp32 sums;
    "pair") or rounded to bf16 once ("bf16"). A bf16 operand's lo part is
    zero, so a product of two bf16 values stays exact."""
    if form == "bf16":
        return torch.einsum(eq, _bf16(a), _bf16(b))
    (ah, al), (bh, bl) = _pair(a), _pair(b)
    return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, al, bh))


def _emulate_scan(xdt, Bv, Cv, log_a, chunk, form):
    """ssm_scan_ref's chunk recurrence with the kernel's rounding of every
    product's operands (``_mm``), accumulated in fp32."""
    B, S, H, hd = xdt.shape
    Q = min(chunk, S)
    x, Bf, Cf, la = (t.float() for t in (xdt, Bv, Cv, log_a))
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    h = torch.zeros((B, H, hd, Bv.shape[-1]))
    ys = []
    for c0 in range(0, S, Q):
        xc, bc, cc = x[:, c0:c0 + Q], Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]
        cum = la[:, c0:c0 + Q].cumsum(dim=1)                      # (B,Q,H)
        M = torch.where(tril[None, :, :, None],
                        torch.exp(cum[:, :, None] - cum[:, None, :]),
                        torch.zeros(()))
        W = M * _mm(cc, bc, "btn,bsn->bts", form)[..., None]       # (B,t,s,H)
        y = _mm(W, xc, "btsh,bshd->bthd", form)
        y = y + torch.exp(cum)[..., None] * _mm(cc, h, "btn,bhdn->bthd",
                                                 form)
        w = torch.exp(cum[:, -1:] - cum)[..., None] * xc           # (B,Q,H,hd)
        h = (torch.exp(cum[:, -1])[..., None, None] * h
             + _mm(w, bc, "bshd,bsn->bhdn", form))
        ys.append(y)
    return torch.cat(ys, dim=1), h


@pytest.mark.parametrize("B,S,H,hd,N,dtype", [
    (1, 100, 8, 64, 128, "bfloat16"),
    (1, 512, 8, 64, 128, "bfloat16"),
    (1, 1024, 4, 64, 128, "bfloat16"),
    (1, 512, 8, 64, 128, "float32")])
def test_ssm_scan_numerics(B, S, H, hd, N, dtype):
    """Why the tensor-core ssm_scan feeds every product's fp32 operand as
    a bf16 pair hi + lo: a CPU emulation of its rounding at the hybrid's
    widths (numpy standard-normal x, B and C in ``dtype``, log_a =
    -0.1 softplus(N(0, 1)) as in chip_smoke.py, seed 0; chunk 128)
    against ``ssm_scan_ref``. The largest share of the limit 1e-4 *
    max |plain| over y and the final state:

        shape (B,S,H,hd,N)       inputs   bf16 operands   bf16 pairs
        1,100,8,64,128           bf16         32.3          0.0394
        1,512,8,64,128           bf16         18.2          0.0330
        1,1024,4,64,128          bf16         20.7          0.0337
        1,512,8,64,128           fp32         32.5          0.0841

    With bf16 inputs C B^T is exact on the tensor cores (a product of two
    bf16 values is exact in fp32); the decay-weighted C B^T, the carried
    state and the weighted x of the state update are fp32, and one bf16
    rounding of them misses the limit by 18-33x. With fp32 inputs x,
    B and C are pairs too (hi hi + hi lo + lo hi)."""
    rng = np.random.default_rng(0)
    x, b, c = (rng.standard_normal(shape, np.float32)
               for shape in ((B, S, H, hd), (B, S, N), (B, S, N)))
    la = (-0.1 * np.log1p(np.exp(rng.standard_normal((B, S, H)))))
    x, b, c = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, b, c))
    la = torch.from_numpy(la.astype(np.float32))
    want = tref.ssm_scan_ref(x, b, c, la, chunk=128)
    share = {}
    for form in ("pair", "bf16"):
        got = _emulate_scan(x, b, c, la, 128, form)
        share[form] = max(float((g - w).abs().max())
                          / (1e-4 * float(w.abs().max()))
                          for g, w in zip(got, want))
    print(f"{(B, S, H, hd, N)} {dtype}: bf16 operands {share['bf16']:.3g}, "
          f"bf16 pairs {share['pair']:.3g}")
    assert share["pair"] <= 0.1     # what the kernel uses: well inside
    assert share["bf16"] > 10       # one bf16 rounding: far outside


@pytest.mark.parametrize("S,chunk", [(20, 16), (17, 16), (100, 64)])
def test_ssm_scan_chunk_rule_raises(S, chunk):
    """S must be at most the chunk or a multiple of it; the plain version
    and the wrapper raise ValueError naming the rule (no padding)."""
    x, b, c, la = (torch.from_numpy(a) for a in
                   _scan_inputs(0, 1, S, 2, 16, 16))
    for fn in (ops.ssm_scan, tref.ssm_scan_ref):
        with pytest.raises(ValueError, match="chunk rule"):
            fn(x, b, c, la, chunk=chunk)


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,K,hd,pos", [
    (2, 64, 4, 2, 32, 0),          # single valid position
    (1, 64, 4, 4, 32, 63),         # MHA, the whole cache
    (2, 512, 8, 2, 64, 300),       # two 256-row tiles, the second partial
])
def test_flash_decode_plain_matches_pallas(B, T, H, K, hd, pos, dtype):
    rng = np.random.default_rng(T + pos)
    qn = rng.standard_normal((B, 1, H, hd), np.float32)
    kn, vn = (rng.standard_normal((B, T, K, hd), np.float32) for _ in "kv")
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (qn, kn, vn))
    tol = 2e-5 if dtype == "float32" else 2e-2
    want = pallas_decode(qj, kj, vj, pos, interpret=True)
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        got = ops.flash_decode(qt, kt, vt, p)
        assert got.dtype == qt.dtype
        _close(got, want, tol)
    _close(ops.flash_decode(qt, kt, vt, pos),
           jref.flash_decode_ref(qj, kj, vj, pos), tol)


def test_flash_decode_refuses_bad_tiles_and_per_slot_positions():
    """The reference's tile rule (T a multiple of min(256, T)) holds, and
    a (B,) position — the dense ring, which takes the plain attention
    instead — is refused on every path."""
    q = torch.zeros((2, 1, 4, 32))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_decode(q, torch.zeros((2, 300, 2, 32)),
                         torch.zeros((2, 300, 2, 32)), 5)
    k = torch.zeros((2, 64, 2, 32))
    for backend in ("auto", "ref"):
        with pytest.raises(ValueError, match="scalar"):
            ops.flash_decode(q, k, k, torch.tensor([3, 4]), backend=backend)


# ---------------------------------------------------------------------------
# layers and the mamba block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(with_state, dtype):
    rng = np.random.default_rng(7)
    B, S, C, W = 2, 6, 24, 4
    (xj, xt), (wj, wt), (bj, bt) = (_both(a, dtype) for a in (
        rng.standard_normal((B, S, C), np.float32),
        rng.standard_normal((W, C), np.float32),
        rng.standard_normal((C,), np.float32)))
    sj = st = None
    if with_state:
        sj, st = _both(rng.standard_normal((B, W - 1, C), np.float32), dtype)
    got, gstate = tlayers.causal_conv1d(xt, wt, bt, st)
    want, wstate = jlayers.causal_conv1d(xj, wj, bj, sj)
    assert got.dtype == xt.dtype and gstate.shape == (B, W - 1, C)
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)
    _close(gstate, wstate, 0)                    # a slice of the input


def _block_params(weights, j=1):
    """Period 0 of pattern block ``j`` (a mamba block) in both packages."""
    jp, tp = weights
    jb = jax.tree.map(lambda a: a[0], jp["decoder"]["layers"][f"block{j}"])
    tb = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tp["decoder"]["layers"][f"block{j}"].items()}
    return jb, tb


def test_mamba_block_prefill_and_decode_match_jax(weights):
    jrun, trun = _runs()
    jcfg, tcfg = jrun.model, trun.model
    jb, tb = _block_params(weights)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, jcfg.d_model), np.float32)
    jy, jc = jssm.mamba_block(jcfg, jb, jnp.asarray(x), jnp.float32,
                              mode="prefill")
    ty, tc = tssm.mamba_block(tcfg, tb, torch.from_numpy(x), torch.float32,
                              mode="prefill")
    _close(ty, jy, 1e-4)
    for k in ("conv", "ssm"):
        _close(tc[k], jc[k], 1e-4, k)
    x1 = rng.standard_normal((2, 1, jcfg.d_model), np.float32)
    jy, jc = jssm.mamba_block(jcfg, jb, jnp.asarray(x1), jnp.float32,
                              mode="decode", cache=jc)
    ty, tc = tssm.mamba_block(tcfg, tb, torch.from_numpy(x1), torch.float32,
                              mode="decode", cache=tc)
    _close(ty, jy, 1e-4)
    for k in ("conv", "ssm"):
        _close(tc[k], jc[k], 1e-4, k)
    # train mode returns no cache
    assert tssm.mamba_block(tcfg, tb, torch.from_numpy(x), torch.float32)[1] \
        is None


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("compute,jax_backend,S", [
    ("float32", "reference", 5), ("float32", "reference", 32),
    ("bfloat16", "pallas", 16), ("bfloat16", "pallas", 32)])
def test_prefill_logits_and_caches_match_jax(weights, compute, jax_backend,
                                             S):
    jp, tp = weights
    jrun, trun = _runs(compute, jax_backend)
    toks = np.random.default_rng(S).integers(0, 512, (2, S))
    jcache, jlog = jax_model(jrun).prefill(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    model = torch_model(trun)
    tcache, tlog = model.prefill(model.compute_params(tp),
                                 {"tokens": torch.tensor(toks)})
    tol = TOL[compute]
    _close(tlog, jlog, tol)
    want = dict(tree_items(jcache))
    got = dict(tree_items(tcache))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        _close(got[path], leaf, tol, str(path))
    assert tcache["block1"]["ssm"].dtype == torch.float32


def _dense_cache(model, cache, T):
    """A prefill cache widened to a dense decode cache of T positions:
    k/v rows copied to the front, recurrent state as it is."""
    B = cache["block0"]["k"].shape[1]
    shape = dataclasses.replace(model.run.shape, seq_len=T, global_batch=B)
    out = model.init_cache(shape, device="cpu")
    for blk, node in cache.items():
        for name, leaf in node.items():
            if name in ("k", "v"):
                out[blk][name][:, :, :leaf.shape[2]] = leaf
            else:
                out[blk][name].copy_(leaf)
    return out


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_then_uniform_decode_matches_forward(weights, compute):
    """prefill(S0) + scalar-pos decode steps through the dense cache ==
    the teacher-forced forward (tests/test_models.py's check), with the
    cache written in place."""
    _, tp = weights
    _, trun = _runs(compute)
    model = torch_model(trun)
    params = model.compute_params(tp)
    B, S, S0, T = 2, 32, 16, 64
    toks = torch.tensor(np.random.default_rng(1).integers(0, 512, (B, S)))
    full = model.forward(params, {"tokens": toks})[0]
    cache, last = model.prefill(params, {"tokens": toks[:, :S0]})
    cache = _dense_cache(model, cache, T)
    k_before = cache["block0"]["k"]
    errs = [float((last - full[:, S0 - 1]).abs().max())]
    for t in range(S0, S):
        pos = t if t % 2 else torch.tensor(t)      # int or 0-d tensor
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], pos)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert cache["block0"]["k"] is k_before
    assert torch.all(cache["block0"]["k"][:, :, S:] == 0)
    scale = float(full.abs().max())
    assert max(errs) < 0.05 * max(scale, 1.0), errs


@pytest.mark.parametrize("compute,jax_backend", [
    ("float32", "reference"), ("bfloat16", "pallas")])
def test_uniform_decode_matches_jax(weights, compute, jax_backend):
    """Three scalar-pos decode steps after a prefill: logits and every
    cache leaf against the JAX model's (flash_decode in interpret mode at
    bf16)."""
    jp, tp = weights
    jrun, trun = _runs(compute, jax_backend)
    jm, tm = jax_model(jrun), torch_model(trun)
    params = tm.compute_params(tp)
    B, S0, T = 2, 16, 32
    toks = np.random.default_rng(2).integers(0, 512, (B, S0 + 3))
    jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S0], jnp.int32)})
    jc = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.pad(a, ((0, 0), (0, 0), (0, T - S0), (0, 0),
                                  (0, 0)))
                      if p[-1].key in ("k", "v") else a), jc)
    tc, _ = tm.prefill(params, {"tokens": torch.tensor(toks[:, :S0])})
    tc = _dense_cache(tm, tc, T)
    tol = TOL[compute]
    for t in range(S0, S0 + 3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1],
                                                    jnp.int32), jnp.int32(t))
        tl, tc = tm.decode_step(params, tc, torch.tensor(toks[:, t:t + 1]),
                                t)
        _close(tl, jl, tol)
    for (path, a), (_, b) in zip(tree_items(jc), tree_items(tc)):
        _close(b, a, tol, str(path))


def test_per_slot_dense_decode_still_raises(weights):
    """Per-slot dense decode (the dense ring, a (B,) ``pos``) against
    JAX's ``Model.decode_step``: slots prefilled to 5, 16 and 32 tokens,
    the middle one inactive (pos -1), two steps. Logits of the active
    rows and every cache leaf within the fp32 tolerance; the inactive
    slot's KV rows and recurrent state bit-untouched. What still raises
    is the kernel: ``ops.flash_decode`` takes one position for the whole
    batch, never a (B,) one (the model sends those to the plain
    attention, as JAX does)."""
    jp, tp = weights
    jrun, trun = _runs()
    jm, tm = jax_model(jrun), torch_model(trun)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    params = tm.compute_params(tp)
    lens, T = (5, 16, 32), 40
    rng = np.random.default_rng(7)
    shape = dataclasses.replace(trun.shape, seq_len=T, global_batch=3)
    dense = tm.init_cache(shape, device="cpu")
    for b, L in enumerate(lens):
        toks = rng.integers(0, 512, (1, L))
        c, _ = jprefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
        for (blk, name), leaf in tree_items(c):
            dst = dense[blk][name]
            leaf = torch.from_numpy(np.array(leaf, np.float32))
            if name in ("k", "v"):
                dst[:, b, :L] = leaf[:, 0]
            else:
                dst[:, b] = leaf[:, 0]
    # a copy: JAX may alias a numpy buffer, and its decode (dispatched
    # asynchronously) must not read the port's in-place writes
    jc = {blk: {n: jnp.asarray(t.numpy().copy()) for n, t in node.items()}
          for blk, node in dense.items()}
    before = {(blk, n): t[:, 1].clone() for blk, node in dense.items()
              for n, t in node.items()}
    active = np.array([True, False, True])
    for step in range(2):
        pos = np.where(active, np.array(lens) + step, -1).astype(np.int32)
        toks = rng.integers(0, 512, (3, 1))
        jl, jc = jdecode(jp, jc, jnp.asarray(toks, jnp.int32),
                         jnp.asarray(pos), active=jnp.asarray(active))
        tl, dense = tm.decode_step(params, dense, torch.tensor(toks),
                                   torch.tensor(pos),
                                   active=torch.tensor(active))
        _close(tl[active], np.asarray(jl)[active], TOL["float32"])
    for (path, a), (_, b) in zip(tree_items(jc), tree_items(dense)):
        _close(b, a, TOL["float32"], str(path))
    for (blk, n), old in before.items():
        assert torch.equal(dense[blk][n][:, 1].view(torch.uint8),
                           old.view(torch.uint8)), (blk, n)
    q = torch.zeros((3, 1, 4, 16))
    kv = torch.zeros((3, T, 2, 16))
    with pytest.raises(ValueError, match="scalar"):
        ops.flash_decode(q, kv, kv, torch.tensor([3, 4, 5]))


def test_model_prefill_breaking_the_chunk_rule_raises(weights):
    _, tp = weights
    _, trun = _runs()
    model = torch_model(trun)
    with pytest.raises(ValueError, match="chunk rule"):
        model.prefill(tp, {"tokens": torch.zeros((1, 20), dtype=torch.int64)})


# ---------------------------------------------------------------------------
# params, interop, compute params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [True, False])
def test_param_shapes_and_count_match_jax(smoke):
    jc = jax_model_config(JAX_ARCH, smoke=smoke)
    jc = dataclasses.replace(jc, moe=None,
                             num_layers=jc.num_layers if smoke else 8)
    tc = torch_model_config(ARCH, smoke=smoke)
    want = {p: (tuple(s.shape), np.dtype(s.dtype).name) for p, s in
            tree_items(jparams.param_shapes(jc, jnp.bfloat16))}
    got = {p: (s.shape, str(s.dtype).removeprefix("torch."))
           for p, s in tree_items(tparams.param_shapes(tc, torch.bfloat16))}
    assert got == want
    assert tc.param_count() == jc.param_count()
    if not smoke:
        assert tc.param_count() == 8_905_349_120


def test_full_config_with_experts_raises():
    """The full config with experts builds since the MoE FFN is ported:
    its params are JAX's (bf16 under the 30 B line) and its smoke model
    raises only where the reference's rules do: a prompt of 528 tokens
    keeps the SSM chunk rule (16) and breaks the MoE group rule (512)."""
    cfg = torch_model_config(JAX_ARCH)
    jc = jax_model_config(JAX_ARCH)
    want = {p: tuple(s.shape) for p, s in
            tree_items(jparams.param_shapes(jc))}
    assert {p: s.shape for p, s in
            tree_items(tparams.param_shapes(cfg))} == want
    assert cfg.param_count() == jc.param_count()
    run = torch_run_config(JAX_ARCH, "decode_32k")
    assert run.precision.params == "bfloat16"
    smoke = torch_run_config(JAX_ARCH, "decode_32k", smoke=True)
    model = torch_model(smoke)
    params = model.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="group rule"):
        model.prefill(params, {"tokens": torch.zeros((1, 528),
                                                     dtype=torch.int64)})


def test_dense_variant_stores_bf16_params_and_init_overrides():
    run = torch_run_config(ARCH, "decode_32k", smoke=True)
    assert run.precision.params == "bfloat16"
    p = torch_model(run).init(seed=0, device="cpu")
    blk = p["decoder"]["layers"]["block1"]
    for name in ("A_log", "D", "dt_bias"):
        assert blk[name].dtype == torch.float32, name
    assert blk["in_proj"].dtype == torch.bfloat16
    n = blk["A_log"].shape[-1]
    jA = np.log(np.linspace(1.0, 8.0, n, dtype=np.float32))
    np.testing.assert_allclose(blk["A_log"][0].numpy(), jA, rtol=1e-6)
    dt = torch.nn.functional.softplus(blk["dt_bias"][0])
    np.testing.assert_allclose(dt.numpy(), np.geomspace(1e-3, 1e-1, n),
                               rtol=1e-5)
    assert torch.all(blk["D"] == 1)


def test_interop_round_trips_hybrid_tree_bit_equal(weights):
    """The hybrid tree, bf16 with fp32 A_log, D and dt_bias inside,
    carries across leaf for leaf, bit-equal both ways."""
    jp, _ = weights
    jrun, _ = _runs()
    mixed = jax_model(dataclasses.replace(
        jrun, precision=JPrecision(params="bfloat16"))).init(
            jax.random.key(1))
    src = jax.tree.map(np.asarray, mixed)
    tp = interop.params_from_jax(src, device="cpu")
    assert tp["decoder"]["layers"]["block1"]["A_log"].dtype == torch.float32
    assert tp["decoder"]["layers"]["block1"]["in_proj"].dtype == \
        torch.bfloat16
    back = dict(tree_items(interop.params_to_jax(tp)))
    for path, leaf in tree_items(src):
        assert back[path].dtype == leaf.dtype, path
        assert np.array_equal(back[path].view(np.uint8),
                              leaf.view(np.uint8)), path


def test_compute_params_keep_conv_w_and_vectors(weights):
    """The bf16 compute copy casts the matrices only: conv_w (nper, 4,
    ch) is read in fp32 by the conv, as in JAX, and stays as stored."""
    _, tp = weights
    _, trun = _runs("bfloat16")
    cp = torch_model(trun).compute_params(tp)
    blk, src = cp["decoder"]["layers"]["block1"], \
        tp["decoder"]["layers"]["block1"]
    assert blk["in_proj"].dtype == blk["ffn"]["wi"].dtype == torch.bfloat16
    for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm"):
        assert blk[name] is src[name], name
    assert all(t.dtype in (torch.float32, torch.bfloat16)
               for t in tree_leaves(cp))
