"""The port's model against the JAX package's, from the same weights:
params built by the JAX init are converted by ``repro_torch.interop`` and
both packages run the same numpy inputs (the smoke config of qwen3-0.6b:
2 layers, d_model 64, 4 query and 2 KV heads, head_dim 32, vocab 512).

Tolerances, each with its reason:
  fp32 compute   1e-4 on logits of magnitude ~1: the frameworks sum in
                 other orders and use other rsqrt/exp/cos approximations,
                 all at fp32 rounding (~1e-7) amplified by two layers
  bf16 compute   5e-2 absolute: activations are rounded to bf16 (8 bits)
                 after every matmul and residual add, and a value on a
                 rounding boundary can land one bf16 step apart in the two
                 frameworks; JAX runs its Pallas kernels (interpret mode),
                 whose fp32-probability numerics the port follows
  int8 KV        the same bf16 bound: quantization is bit-identical
                 (tests/test_torch_kernels.py), so int8 adds no gap
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.models import layers as jlayers
from repro.models import params as jparams
from repro.models.model import build_model as jax_model
from repro.serve import paged as jpaged
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models.model import build_model as torch_model
from repro_torch.serve import paged as tpaged
from repro_torch.tree import tree_items, tree_leaves

ARCH = "qwen3-0.6b"


def _runs(compute="float32", jax_backend="reference"):
    jrun = jax_run_config(ARCH, "decode_32k", smoke=True,
                          precision=JPrecision(compute=compute),
                          kernel_backend=jax_backend)
    trun = torch_run_config(ARCH, "decode_32k", smoke=True,
                            precision=TPrecision(compute=compute))
    return jrun, trun


@pytest.fixture(scope="module")
def weights():
    jrun, _ = _runs()
    jp = jax_model(jrun).init(jax.random.key(0))
    return jp, interop.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# params and interop
# ---------------------------------------------------------------------------
def test_interop_round_trips_every_leaf_bit_equal(weights):
    jp, tp = weights
    back = interop.params_to_jax(tp)
    want = dict(tree_items(jax.tree.map(np.asarray, jp)))
    got = dict(tree_items(back))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        assert np.array_equal(got[path].view(np.uint8),
                              leaf.view(np.uint8)), path
    # bf16 leaves keep their bits too
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jp)
    tb = interop.params_from_jax(bf, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tb))
    for (path, a), (_, b) in zip(tree_items(bf),
                                 tree_items(interop.params_to_jax(tb))):
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16)), path


@pytest.mark.parametrize("smoke", [True, False])
def test_param_shapes_and_count_match_jax(smoke):
    from repro.configs import get_model_config as jcfg
    from repro_torch.configs import get_model_config as tcfg
    jc, tc = jcfg(ARCH, smoke=smoke), tcfg(ARCH, smoke=smoke)
    want = {p: tuple(s.shape) for p, s in
            tree_items(jparams.param_shapes(jc))}
    got = {p: s.shape for p, s in tree_items(tparams.param_shapes(tc))}
    assert got == want
    assert tc.param_count() == jc.param_count()


def test_seeded_init_shapes_and_scale():
    _, trun = _runs()
    model = torch_model(trun)
    a = model.init(seed=3, device="cpu")
    b = model.init(seed=3, device="cpu")
    c = model.init(seed=4, device="cpu")
    shapes = {p: tuple(s.shape) for p, s in tree_items(model.param_shapes())}
    assert {p: tuple(t.shape) for p, t in tree_items(a)} == shapes
    for (p, x), (_, y) in zip(tree_items(a), tree_items(b)):
        assert torch.equal(x, y), p
    wq = a["decoder"]["layers"]["block0"]["wq"]
    assert not torch.equal(wq, c["decoder"]["layers"]["block0"]["wq"])
    # truncated N(0,1) on [-2, 2] has std 0.8796; fan-in counts the
    # period axis, as in the JAX init
    fan_in = wq.shape[0] * wq.shape[1]
    assert abs(float(wq.std()) * fan_in ** 0.5 - 0.8796) < 0.03
    assert float(wq.abs().max()) <= 2.0 / fan_in ** 0.5 + 1e-7
    assert torch.all(a["decoder"]["final_norm"] == 1)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32), np.float32)
    w = rng.standard_normal((32,), np.float32)
    np.testing.assert_allclose(
        _f32(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        _f32(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-5, rtol=1e-5)
    assert np.array_equal(tlayers.rope_freqs(32, 1e6),
                          np.asarray(jlayers.rope_freqs(32, 1e6)))
    for pos in (np.arange(5), np.asarray([[3, 4, 5, 6, 7], [0, 1, 2, 3, 9]])):
        np.testing.assert_allclose(
            _f32(tlayers.apply_rope(torch.from_numpy(x),
                                    torch.from_numpy(pos), 1e6)),
            _f32(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
            atol=1e-5, rtol=1e-5)
    h = rng.standard_normal((3, 16), np.float32)
    wi, wg = (rng.standard_normal((16, 24), np.float32) for _ in "ig")
    wo = rng.standard_normal((24, 16), np.float32)
    np.testing.assert_allclose(
        _f32(tlayers.swiglu(*(torch.from_numpy(a) for a in (h, wi, wg, wo)),
                            torch.float32)),
        _f32(jlayers.swiglu(*(jnp.asarray(a) for a in (h, wi, wg, wo)),
                            jnp.float32)),
        atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# prefill and paged decode logits
# ---------------------------------------------------------------------------
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("compute,jax_backend,S", [
    ("float32", "reference", 13), ("float32", "reference", 40),
    ("bfloat16", "pallas", 16), ("bfloat16", "pallas", 64)])
def test_prefill_logits_match_jax(weights, compute, jax_backend, S):
    jp, tp = weights
    jrun, trun = _runs(compute, jax_backend)
    toks = np.random.default_rng(S).integers(0, 512, (1, S))
    jcache, jlog = jax_model(jrun).prefill(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tcache, tlog = torch_model(trun).prefill(tp,
                                             {"tokens": torch.tensor(toks)})
    tol = TOL[compute]
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), atol=tol, rtol=tol)
    for (path, a), (_, b) in zip(tree_items(jcache), tree_items(tcache)):
        np.testing.assert_allclose(_f32(b), _f32(a), atol=tol, rtol=tol,
                                   err_msg=str(path))


def _decode_two_steps(pkg, model, params, prompts, kv_dtype, page=8):
    """Prefill each prompt into its own pages of a fresh pool, then two
    batched paged decode steps (one slot left inactive). Returns the
    logits of both steps."""
    np_, torch_ = pkg == "jax", pkg == "torch"
    paged = jpaged if np_ else tpaged
    B, NP = len(prompts) + 1, 4
    shape = dataclasses.replace(model.run.shape, seq_len=NP * page,
                                global_batch=B)
    kw = {} if np_ else {"device": "cpu"}
    cache = paged.init_paged_cache(model, shape, 1 + B * NP, page,
                                   kv_dtype=kv_dtype, **kw)
    tables = np.zeros((B, NP), np.int32)
    pos = np.full((B,), -1, np.int32)
    for b, pr in enumerate(prompts):
        toks = (jnp.asarray(pr, jnp.int32) if np_
                else torch.tensor(pr))[None]
        req, _ = model.prefill(params, {"tokens": toks})
        pages = list(range(1 + b * NP, 1 + b * NP + NP))
        n = -(-len(pr) // page)
        cache = paged.admit_kv(cache, req, pages[:n], page, b)
        tables[b] = pages
        pos[b] = len(pr) - 1
    active = pos >= 0
    out = []
    for step in range(2):
        pos = np.where(active, pos + 1, -1).astype(np.int32)
        toks = np.where(active, 7 * step + 3, 0)[:, None]
        if np_:
            lg, cache = model.decode_step(
                params, cache, jnp.asarray(toks, jnp.int32),
                jnp.asarray(pos), tables=jnp.asarray(tables),
                active=jnp.asarray(active))
        else:
            lg, cache = model.decode_step(
                params, cache, torch.tensor(toks), torch.tensor(pos),
                tables=torch.tensor(tables), active=torch.tensor(active))
        out.append(_f32(lg)[active])
    assert torch_ is not np_
    return out


@pytest.mark.parametrize("compute,jax_backend,kv_dtype", [
    ("float32", "reference", None), ("float32", "reference", "int8"),
    ("bfloat16", "pallas", None), ("bfloat16", "pallas", "int8")])
def test_paged_decode_logits_match_jax(weights, compute, jax_backend,
                                       kv_dtype):
    jp, tp = weights
    jrun, trun = _runs(compute, jax_backend)
    prompts = [list(range(3, 14)), [5, 9, 2, 2, 7, 31, 400, 8]]
    want = _decode_two_steps("jax", jax_model(jrun), jp, prompts, kv_dtype)
    got = _decode_two_steps("torch", torch_model(trun), tp, prompts,
                            kv_dtype)
    tol = TOL[compute]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)
