"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU at smoke widths: the same
numpy inputs and the same weights (the JAX init, converted).

Routing is compared bit for bit: from the same fp32 router logits both
packages must pick the same experts (``idx``) and build the same
``dispatch`` one-hots, since a one-ulp change of a logit near a tie
would move a token to another expert and every later token of its group
to another slot. ``combine`` carries the gate values, a softmax of the
logits: XLA's and PyTorch's ``exp`` differ by one ulp on some inputs (28
of 384 fp32 values in the first case here), and the gates normalize
probabilities by their sum, so ``combine`` is held to 2**-21 relative at
fp32 (a few ulps) and one bf16 step at bf16, where ``dispatch`` is
exact. The JAX side's routing tensors are read off
its own ``moe_ffn`` (a spy on ``jax.lax.top_k`` and ``jnp.einsum``) fed
with the router logits themselves: x = logits through an identity router
(D = E), a product that is exact in fp32.

Tolerances: the FFN's output and aux losses 1e-5 at fp32 (sums in other
orders over a few products); logits through the model 1e-4 at fp32 and
5e-2 at bf16 (``tests/test_torch_model.py``'s reasons).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JMoE
from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.models import moe as jmoe
from repro.models.model import build_model as jax_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import interop
from repro_torch.configs import MoEConfig as TMoE
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model as torch_model
from repro_torch.serve.engine import Request, ServeEngine

OLMOE, ARCTIC, JAMBA = "olmoe-1b-7b", "arctic-480b", "jamba-1.5-large-398b"
_SETUPS = {}


def _setup(arch, compute="float32", jax_backend="reference"):
    """(jrun, JAX params, trun, port params) at smoke size."""
    key = (arch, compute, jax_backend)
    if key not in _SETUPS:
        jrun = jax_run_config(arch, "decode_32k", smoke=True,
                              precision=JPrecision(compute=compute),
                              kernel_backend=jax_backend)
        trun = torch_run_config(arch, "decode_32k", smoke=True,
                                precision=TPrecision(compute=compute))
        jp = jax_model(jrun).init(jax.random.key(0))
        tp = interop.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _SETUPS[key] = (jrun, jp, trun, tp)
    return _SETUPS[key]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _moe_params(jp, block="block0"):
    """The first period's MoE leaves, as JAX and as torch."""
    p = jax.tree.map(lambda a: a[0], jp["decoder"]["layers"][block]["moe"])
    return p, {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,B,S", [(OLMOE, 2, 16), (OLMOE, 1, 1024),
                                      (ARCTIC, 2, 24), (ARCTIC, 4, 1)])
def test_moe_ffn_matches_jax(arch, B, S):
    """y and both aux losses at fp32 on the smoke config's first MoE
    layer (olmoe: 8 experts top-2; arctic: 4 experts top-2), in one group
    (S <= 512), in two (S 1,024) and at decode (S 1, one token a group,
    capacity 1)."""
    jrun, jp, trun, _ = _setup(arch)
    pj, pt = _moe_params(jp)
    x = np.random.default_rng(S + B).standard_normal(
        (B, S, jrun.model.d_model), np.float32)
    yj, auxj = jmoe.moe_ffn(jnp.asarray(x), pj, jrun.model.moe, jnp.float32)
    yt, auxt = tmoe.moe_ffn(torch.from_numpy(x), pt, trun.model.moe,
                            torch.float32)
    np.testing.assert_allclose(_f32(yt), _f32(yj), atol=1e-5, rtol=1e-5)
    assert set(auxt) == set(auxj) == {"load_balance", "router_z"}
    for k in auxj:
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]),
                                   rtol=1e-5, err_msg=k)


class _Spy:
    """Records what ``repro.models.moe.moe_ffn`` routes: top-k's indices,
    the dispatch (first operand of "gsec,gsd->egcd") and combine (first
    operand of "gsec,egcd->gsd")."""

    def __init__(self, monkeypatch):
        self.seen = {}
        top_k, einsum = jax.lax.top_k, jnp.einsum

        def spy_top_k(x, k):
            out = top_k(x, k)
            self.seen["idx"] = np.asarray(out[1])
            return out

        def spy_einsum(spec, *ops, **kw):
            if spec == "gsec,gsd->egcd":
                self.seen["dispatch"] = np.asarray(ops[0])
            elif spec == "gsec,egcd->gsd":
                self.seen["combine"] = np.asarray(ops[0])
            return einsum(spec, *ops, **kw)

        monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
        monkeypatch.setattr(jnp, "einsum", spy_einsum)


def _logits(case, G, sg, E, seed):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((G, sg, E)).astype(np.float32)
    if case == "ties":
        # exact ties, also among the top choices: rounded to a coarse grid
        lg = np.round(lg * 2) / 2
    elif case == "skewed":
        # most tokens want expert 1 first and expert 0 second: both run
        # out of capacity, and the overflowing tokens are dropped
        lg[..., 1] += 4.0
        lg[..., 0] += 3.0
    return lg


@pytest.mark.parametrize("case,sg,moe", [
    ("random", 16, dict(num_experts=8, num_experts_per_token=2)),
    ("ties", 16, dict(num_experts=8, num_experts_per_token=2)),
    ("skewed", 16, dict(num_experts=8, num_experts_per_token=2)),
    # sg*K/E*cf = 8*2/8*1.25 = 2.5: Python's round gives 2, not 3
    ("skewed", 8, dict(num_experts=8, num_experts_per_token=2)),
    # 8*2/8*1.75 = 3.5 rounds to 4
    ("skewed", 8, dict(num_experts=8, num_experts_per_token=2,
                       capacity_factor=1.75)),
    ("random", 64, dict(num_experts=64, num_experts_per_token=8)),
    ("random", 1, dict(num_experts=64, num_experts_per_token=8)),
])
def test_routing_bit_equal_from_shared_logits(monkeypatch, case, sg, moe):
    """From the same fp32 logits (G=3 groups): idx and dispatch
    bit-equal to what the JAX moe_ffn builds, combine within a few ulps
    (the softmax's exp), at fp32 and bf16 compute; the skewed
    cases drop tokens."""
    E = moe["num_experts"]
    jcfg, tcfg = JMoE(d_ff=8, **moe), TMoE(d_ff=8, **moe)
    lg = _logits(case, 3, sg, E, seed=sg + E)
    rng = np.random.default_rng(1)
    p = {"router": np.eye(E, dtype=np.float32),
         "wi": rng.standard_normal((E, E, 8)).astype(np.float32),
         "wg": rng.standard_normal((E, E, 8)).astype(np.float32),
         "wo": rng.standard_normal((E, 8, E)).astype(np.float32)}
    spy = _Spy(monkeypatch)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        x = lg                      # B = G = 3 rows of S = sg tokens
        if jdt == jnp.bfloat16:
            # the router runs in the compute dtype: bf16-exact logits
            x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        jmoe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                      p.items()}, jcfg, jdt)
        got_lg = torch.from_numpy(x.reshape(3, sg, E))
        _, idx, dispatch, combine = tmoe.route(got_lg, tcfg, tdt)
        assert np.array_equal(idx.numpy(), spy.seen["idx"].reshape(3, sg, -1))
        for name, t in (("dispatch", dispatch), ("combine", combine)):
            want = spy.seen[name]
            assert str(t.dtype).removeprefix("torch.") == want.dtype.name
            got, want = t.to(torch.float32).numpy(), want.astype(np.float32)
            assert np.array_equal(got != 0, want != 0), name
            if name == "dispatch":
                assert np.array_equal(got, want)
            else:
                ulp = 2.0 ** -21 if tdt == torch.float32 else 2.0 ** -7
                np.testing.assert_allclose(got, want, rtol=ulp, atol=0)
    cap = dispatch.shape[-1]
    assert cap == tmoe.capacity(sg, tcfg) == max(1, round(
        sg * moe["num_experts_per_token"] / E
        * moe.get("capacity_factor", 1.25)))
    kept = dispatch.to(torch.float32).sum((-1, -2))        # per token
    if case == "skewed":
        assert float(kept.min()) < moe["num_experts_per_token"]  # drops
    # no expert takes more tokens than its capacity in any group
    assert float(dispatch.to(torch.float32).sum((1, 3)).max()) <= cap


def test_capacity_rounds_half_to_even():
    moe = TMoE(num_experts=8, num_experts_per_token=2, d_ff=8)
    assert tmoe.capacity(8, moe) == 2          # 2.5
    assert tmoe.capacity(16, moe) == 5
    assert tmoe.capacity(24, moe) == 8         # 7.5
    olmoe = torch_run_config(OLMOE, "decode_32k").model.moe
    assert tmoe.capacity(1, olmoe) == 1        # 0.156 -> 0 -> at least 1
    assert tmoe.capacity(512, olmoe) == 80


# ---------------------------------------------------------------------------
# the layer rule and the model
# ---------------------------------------------------------------------------
def test_every_offset_rule_places_moe_like_jax():
    """jamba's smoke config (MoE every 2nd layer from 1): block1 and
    block3 hold the experts and no dense FFN, block0 and block2 the dense
    FFN; the loss's aux terms are those of JAX and nonzero."""
    from repro.data.pipeline import SyntheticSource as JSource
    jrun, jp, trun, tp = _setup(JAMBA)
    layers = tp["decoder"]["layers"]
    for j in range(4):
        assert ("moe" in layers[f"block{j}"]) == (j % 2 == 1)
        assert ("ffn" in layers[f"block{j}"]) == (j % 2 == 0)
        assert trun.model.layer_has_moe(j) == jrun.model.layer_has_moe(j)
    b = JSource(jrun, batch_override=2, seq_override=32).batch_at(0)
    _, jm = jax_model(jrun).loss(jp, {k: jnp.asarray(v) for k, v in
                                      b.items()})
    with torch.no_grad():
        _, tm = torch_model(trun).loss(tp, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
    for k in ("loss", "ce", "load_balance", "router_z"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(tm["load_balance"]) > 0 and float(tm["router_z"]) > 0


def test_aux_losses_reach_the_loss_and_its_gradient():
    """The aux losses are summed over the stack into ``Model.loss``
    (loss = ce + load_balance + router_z, as JAX), and the router gets a
    gradient."""
    _, _, trun, tp = _setup(OLMOE)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 500, (2, 16)))
    model = torch_model(trun)
    router = tp["decoder"]["layers"]["block0"]["moe"]["router"]
    leaf = router.detach().clone().requires_grad_(True)
    params = dict(tp)
    params["decoder"] = dict(tp["decoder"], layers={"block0": dict(
        tp["decoder"]["layers"]["block0"],
        moe=dict(tp["decoder"]["layers"]["block0"]["moe"], router=leaf))})
    loss, m = model.loss(params, {"tokens": toks, "labels": toks})
    np.testing.assert_allclose(
        float(loss), float(m["ce"] + m["load_balance"] + m["router_z"]),
        rtol=1e-6)
    loss.backward()
    assert leaf.grad is not None and float(leaf.grad.abs().sum()) > 0


def test_group_rule_raises_in_the_model():
    """More than 512 tokens that are not a multiple of 512 in a batch row
    break the group rule: JAX asserts, the port raises ValueError (it
    never pads); 1,024 tokens make two groups."""
    jrun, jp, trun, tp = _setup(OLMOE)
    pj, pt = _moe_params(jp)
    x = np.zeros((1, 600, 64), np.float32)
    with pytest.raises(AssertionError):
        jmoe.moe_ffn(jnp.asarray(x), pj, jrun.model.moe, jnp.float32)
    with pytest.raises(ValueError, match="group rule"):
        tmoe.moe_ffn(torch.from_numpy(x), pt, trun.model.moe, torch.float32)
    with pytest.raises(ValueError, match="group rule"):
        torch_model(trun).prefill(tp, {"tokens": torch.zeros(
            (1, 600), dtype=torch.int64)})
    assert tmoe.check_moe_groups(1, 1024) == 512
    assert tmoe.check_moe_groups(3, 100) == 100


def test_engine_rejects_a_prompt_breaking_the_group_rule():
    """A 600-token prompt is rejected at admission with the rule's
    message; the engine serves the rest (a 512-token prompt too)."""
    _, _, trun, tp = _setup(OLMOE)
    eng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=640)
    bad = Request(rid=0, prompt=np.arange(600) % 500, max_new_tokens=2)
    ok = Request(rid=1, prompt=np.arange(512) % 500, max_new_tokens=2)
    eng.submit(bad)
    eng.submit(ok)
    done = eng.run_until_idle()
    assert done.drained and bad.done and ok.done
    assert "group rule" in bad.error and not bad.out
    assert ok.error is None and len(ok.out) == 2


@pytest.mark.parametrize("compute,jax_backend,tol", [
    ("float32", "reference", 1e-4), ("bfloat16", "pallas", 5e-2)])
def test_olmoe_prefill_logits_match_jax(compute, jax_backend, tol):
    """olmoe's prefill logits and cache at fp32 (1e-4) and bf16 (5e-2, JAX
    through its Pallas kernels in interpret mode)."""
    jrun, jp, trun, tp = _setup(OLMOE, compute, jax_backend)
    toks = np.random.default_rng(5).integers(0, 512, (1, 48))
    jc, jl = jax_model(jrun).prefill(jp, {"tokens": jnp.asarray(toks,
                                                                jnp.int32)})
    with torch.no_grad():
        tc, tl = torch_model(trun).prefill(tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=tol)
    for blk in jc:
        for name in jc[blk]:
            np.testing.assert_allclose(_f32(tc[blk][name]),
                                       _f32(jc[blk][name]), atol=tol,
                                       rtol=tol, err_msg=f"{blk}/{name}")


def _requests(cls, lens=(4, 16, 9, 32, 12)):
    return [cls(rid=i, prompt=(np.arange(n) * (i + 2) + 1) % 500,
                max_new_tokens=8, temperature=0.8 if i % 2 else 0.0,
                top_k=16 if i % 4 == 1 else 0, seed=3 + i)
            for i, n in enumerate(lens)]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    assert engine.run_until_idle().drained
    assert all(r.done and r.error is None for r in reqs)
    return [list(r.out) for r in reqs]


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_matches_jax_chunked_prefill(paged):
    """Chunked prefill (chunks of 4) regroups the MoE's tokens chunk by
    chunk, so where capacity drops tokens it differs from a whole-prompt
    prefill, in JAX too: the port's chunked engine is held to JAX's
    chunked engine, token for token at fp32."""
    jrun, jp, trun, tp = _setup(OLMOE)
    kw = dict(slots=2, max_len=64, prefill_chunk=4, paged=paged,
              fused_sampling=True)
    want = _serve(JEngine(jrun, jp, **kw), _requests(JRequest))
    teng = ServeEngine(trun, tp, device="cpu", **kw)
    assert teng.prefill_chunk == 4
    assert _serve(teng, _requests(Request)) == want


def test_chunk_logits_match_jax():
    """One chunked prefill, chunk by chunk (8 tokens at offsets 0, 8, 16
    into a 32-row staging cache): each chunk's logits as JAX's."""
    jrun, jp, trun, tp = _setup(OLMOE)
    jm, tm = jax_model(jrun), torch_model(trun)
    shape = dataclasses.replace(trun.shape, seq_len=32, global_batch=1)
    jcache = jm.init_cache(shape)
    tcache = tm.init_cache(shape, device="cpu")
    toks = np.random.default_rng(2).integers(0, 512, (1, 24))
    for off in (0, 8, 16):
        chunk = toks[:, off:off + 8]
        jcache, jl = jm.prefill_chunk(jp, jcache, jnp.asarray(chunk,
                                                             jnp.int32),
                                      jnp.int32(off))
        with torch.no_grad():
            tcache, tl = tm.prefill_chunk(tp, tcache, torch.tensor(chunk),
                                          torch.tensor(off))
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=1e-4)
