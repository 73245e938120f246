"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's (``repro.models.xlstm``), on the CPU: the chunkwise mLSTM, its
decode step and the sLSTM recurrence from the same numpy inputs and
states, the smoke model's prefill + decode against its teacher-forced
forward (the contract of ``tests/test_models.py``), and the mLSTM chunk
rule, which the port raises and the engine enforces at admission.

Tolerances: 1e-4 at fp32 on outputs and states of magnitude ~1 (sums in
other orders, and exp/log of the stabilized gates, amplified through a
few tokens of recurrence); the teacher-forced contract 5e-2 of max
|logit| at bf16 compute (the JAX test's bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.models import xlstm as jx
from repro.models.model import build_model as jax_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.models import xlstm as tx
from repro_torch.models.model import build_model as torch_model
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "xlstm-350m"
TOL = 1e-4


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(
        got.detach().to(torch.float32).numpy() if isinstance(
            got, torch.Tensor) else np.asarray(got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _gates(rng, B, S, H):
    log_f = np.log(1 / (1 + np.exp(-rng.standard_normal((B, S, H)) - 2)))
    log_i = rng.standard_normal((B, S, H))
    return log_f.astype(np.float32), log_i.astype(np.float32)


def _state(rng, B, H, hd):
    return {"C": rng.standard_normal((B, H, hd, hd)).astype(np.float32),
            "n": rng.standard_normal((B, H, hd)).astype(np.float32),
            "m": rng.standard_normal((B, H)).astype(np.float32)}


@pytest.mark.parametrize("S,chunk,with_state", [
    (16, 16, False), (48, 16, False), (32, 8, True), (5, 16, True)])
def test_mlstm_chunked_matches_jax(S, chunk, with_state):
    """h and the final (C, n, m) over one chunk, three chunks, four with a
    carried-in state, and a sequence shorter than the chunk."""
    rng = np.random.default_rng(S + chunk)
    B, H, hd = 2, 2, 8
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in "qkv")
    lf, li = _gates(rng, B, S, H)
    st = _state(rng, B, H, hd) if with_state else None
    hj, sj = jx.mlstm_chunked(*(jnp.asarray(a) for a in (q, k, v, lf, li)),
                              state=None if st is None else
                              {n: jnp.asarray(a) for n, a in st.items()},
                              chunk=chunk)
    ht, stt = tx.mlstm_chunked(*(_t(a) for a in (q, k, v, lf, li)),
                               state=None if st is None else
                               {n: _t(a) for n, a in st.items()},
                               chunk=chunk)
    _close(ht, hj, msg="h")
    for n in ("C", "n", "m"):
        _close(stt[n], sj[n], msg=n)


def test_mlstm_step_matches_jax():
    rng = np.random.default_rng(3)
    B, H, hd = 3, 2, 8
    q, k, v = (rng.standard_normal((B, H, hd)).astype(np.float32)
               for _ in "qkv")
    lf, li = (a[:, 0] for a in _gates(rng, B, 1, H))
    st = _state(rng, B, H, hd)
    hj, sj = jx.mlstm_step(*(jnp.asarray(a) for a in (q, k, v, lf, li)),
                           {n: jnp.asarray(a) for n, a in st.items()})
    ht, stt = tx.mlstm_step(*(_t(a) for a in (q, k, v, lf, li)),
                            {n: _t(a) for n, a in st.items()})
    _close(ht, hj)
    for n in ("C", "n", "m"):
        _close(stt[n], sj[n], msg=n)


_SETUPS = {}


def _setup(compute="float32"):
    if compute not in _SETUPS:
        jrun = jax_run_config(ARCH, "decode_32k", smoke=True,
                              precision=JPrecision(compute=compute))
        trun = torch_run_config(ARCH, "decode_32k", smoke=True,
                                precision=TPrecision(compute=compute))
        jp = jax_model(jrun).init(jax.random.key(0))
        tp = interop.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _SETUPS[compute] = (jrun, jp, trun, tp)
    return _SETUPS[compute]


@pytest.mark.parametrize("mode,S", [("prefill", 12), ("train", 32),
                                    ("decode", 1)])
def test_blocks_match_jax(mode, S):
    """The smoke config's mLSTM (block0) and sLSTM (block3) blocks: output
    and new state from the same weights; decode continues a random
    state."""
    jrun, jp, trun, tp = _setup()
    rng = np.random.default_rng(S)
    B, D = 2, jrun.model.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    H, hdm = 4, jrun.model.xlstm.head_dim
    for blk, jfn, tfn, cache in (
            ("block0", jx.mlstm_block, tx.mlstm_block,
             {"mlstm": _state(rng, B, H, hdm)}),
            ("block3", jx.slstm_block, tx.slstm_block,
             {"slstm": {n: rng.standard_normal((B, D)).astype(np.float32)
                        + (2.0 if n == "n" else 0.0)
                        for n in ("h", "c", "n", "m")}})):
        pj = jax.tree.map(lambda a: a[0], jp["decoder"]["layers"][blk])
        pt = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), pj)
        if mode != "decode":
            cache = None
        jc = jax.tree.map(jnp.asarray, cache)
        tc = jax.tree.map(_t, cache)
        oj, ncj = jfn(jrun.model, pj, jnp.asarray(x), jnp.float32,
                      mode=mode, cache=jc)
        ot, nct = tfn(trun.model, pt, torch.from_numpy(x), torch.float32,
                      mode=mode, cache=tc)
        _close(ot, oj, msg=f"{blk} out")
        if mode == "train":
            assert ncj is None and nct is None
            continue
        for (path, a) in jax.tree_util.tree_leaves_with_path(ncj):
            keys = [p.key for p in path]
            _close(nct[keys[0]][keys[1]], a, msg=f"{blk} {keys}")


def test_fresh_caches_seed_the_stabilizers():
    """init_cache sets every "m" leaf (mLSTM and sLSTM) to -1e30, zeros
    elsewhere, as JAX; a fresh sLSTM carry (no cache) starts at -30."""
    jrun, _, trun, _ = _setup()
    shape = dataclasses.replace(trun.shape, seq_len=16, global_batch=2)
    jc = jax_model(jrun).init_cache(shape)
    tc = torch_model(trun).init_cache(shape, device="cpu")
    for path, a in jax.tree_util.tree_leaves_with_path(jc):
        keys = [p.key for p in path]
        node = tc
        for k in keys:
            node = node[k]
        assert tuple(node.shape) == a.shape and node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(a)), keys
    m = tc["block0"]["mlstm"]["m"]
    assert torch.equal(m, torch.full_like(m, -1e30))
    assert tx.SLSTM_M0 == -30.0


@pytest.mark.parametrize("S0", [8, 32])
def test_prefill_then_decode_matches_teacher_forced(S0):
    """prefill(S0) + per-token decode == the teacher-forced forward
    logits, within 5% of max |logit| (the JAX contract) at the port's
    bf16 compute; S0 = 32 prefills in two chunks of 16."""
    run = torch_run_config(ARCH, "train_4k", smoke=True)
    model = torch_model(run)
    params = model.init(seed=0, device="cpu")
    B, S = 2, 48                    # the forward obeys the chunk rule
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512,
                                                              (B, S)))
    with torch.no_grad():
        full, _, _ = model.forward(params, {"tokens": toks}, "train")
        cache, last = model.prefill(params, {"tokens": toks[:, :S0]})
        errs = [float((last - full[:, S0 - 1]).abs().max())]
        for t in range(S0, S):
            lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
            errs.append(float((lg - full[:, t]).abs().max()))
    scale = float(full.abs().max())
    assert max(errs) < 0.05 * max(scale, 1.0), errs


@pytest.mark.parametrize("S,chunk", [(20, 16), (17, 16), (100, 64)])
def test_mlstm_chunk_rule_raises(S, chunk):
    """A sequence longer than the chunk and not a multiple of it: JAX
    asserts, the port raises ValueError naming the rule (no padding)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, S, 2, 8)).astype(np.float32)
    lf, li = _gates(rng, 1, S, 2)
    with pytest.raises(AssertionError):
        jx.mlstm_chunked(*(jnp.asarray(a) for a in (q, q, q, lf, li)),
                         chunk=chunk)
    with pytest.raises(ValueError, match="chunk rule"):
        tx.mlstm_chunked(*(_t(a) for a in (q, q, q, lf, li)), chunk=chunk)


def test_engine_rejects_a_prompt_breaking_the_chunk_rule():
    """A 20-token prompt (chunk 16) is rejected at admission with the
    rule's message; 16- and 32-token prompts are served as JAX serves
    them (fp32, dense ring: the only layout of an attention-free
    stack)."""
    jrun, jp, trun, tp = _setup()
    eng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=48,
                      fused_sampling=True)
    assert eng.prefill_chunk == 0
    with pytest.raises(ValueError, match="attention-free"):
        ServeEngine(trun, tp, device="cpu", paged=True)

    def reqs(cls, lens):
        return [cls(rid=i, prompt=(np.arange(n) * 3 + i) % 500,
                    max_new_tokens=6, temperature=0.8 if i % 2 else 0.0,
                    seed=i) for i, n in enumerate(lens)]
    bad, *good = reqs(Request, (20, 16, 32, 5))
    for r in [bad] + good:
        eng.submit(r)
    assert eng.run_until_idle().drained
    assert "chunk rule" in bad.error and not bad.out
    jeng = JEngine(jrun, jp, slots=2, max_len=48, fused_sampling=True)
    want = reqs(JRequest, (20, 16, 32, 5))[1:]
    for r in want:
        jeng.submit(r)
    jeng.run_until_idle()
    assert [r.out for r in good] == [r.out for r in want]
