"""The port's paged ServeEngine against the JAX package's, end to end.

Both engines serve the same requests from the same weights (the JAX init,
converted) at fp32 compute, where the two frameworks' logits agree to
~1e-6 and the sampled token streams must be identical — with bf16 and
int8 KV pages, fused (on-device) and host sampling, greedy and sampled
requests mixed. A mismatch reports the first divergent token.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.models.model import build_model as jax_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.paged import BlockAllocator as JAllocator
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.serve.engine import DrainResult, Request, ServeEngine
from repro_torch.serve.paged import (BlockAllocator, CacheExhausted,
                                     RequestRejected)
from repro_torch.tree import tree_leaves, tree_to

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def setup():
    jrun = jax_run_config(ARCH, "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"))
    trun = torch_run_config(ARCH, "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"))
    jp = jax_model(jrun).init(jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jrun, jp, trun, tp


def _requests(cls, n=5, new=8, shared=None):
    """Mixed greedy and sampled requests (temperature 0.8, top-k 0 or 16),
    with varied prompt lengths; ``shared`` makes the prompts a common
    prefix plus one of two last tokens, so pairs of prompts are equal."""
    out = []
    for i in range(n):
        prompt = (np.arange(5 + 3 * i) * (i + 2) + 1) % 500
        if shared is not None:
            prompt = np.concatenate([shared, [i % 2]])
        out.append(cls(rid=i, prompt=prompt, max_new_tokens=new,
                       temperature=0.8 if i % 2 else 0.0,
                       top_k=16 if i % 4 == 1 else 0, seed=3 + i))
    return out


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    res = engine.run_until_idle()
    assert res.drained and all(r.done and not r.error for r in reqs)
    return [list(r.out) for r in reqs]


def _assert_streams_equal(got, want):
    for rid, (g, w) in enumerate(zip(got, want)):
        if g != w:
            i = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                     min(len(g), len(w)))
            pytest.fail(f"request {rid} diverges at token {i}: "
                        f"port {g[i:i + 4]} vs JAX {w[i:i + 4]}")
    assert len(got) == len(want)


def _engines(setup, **kw):
    jrun, jp, trun, tp = setup
    common = dict(dict(slots=2, max_len=48, paged=True, page_size=8), **kw)
    return (JEngine(jrun, jp, **common),
            ServeEngine(trun, tp, device="cpu", **common))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("fused", [False, True])
def test_engine_streams_identical_to_jax(setup, kv_dtype, fused):
    jeng, teng = _engines(setup, kv_dtype=kv_dtype, fused_sampling=fused)
    want = _serve(jeng, _requests(JRequest))
    got = _serve(teng, _requests(Request))
    _assert_streams_equal(got, want)
    assert teng.alloc.num_free == teng.alloc.capacity


def test_prefix_sharing_cow_streams_identical_to_jax(setup):
    """Shared-prefix pages (trie), copy-on-write splits and lazy extends
    take the same decisions and give the same tokens as the JAX engine."""
    shared = (np.arange(11) * 3) % 100
    jeng, teng = _engines(setup, slots=4, share_prefix=True,
                          fused_sampling=True)
    want = _serve(jeng, _requests(JRequest, n=4, shared=shared))
    got = _serve(teng, _requests(Request, n=4, shared=shared))
    _assert_streams_equal(got, want)
    assert teng.stats == jeng.stats
    assert teng.stats["cow_splits"] > 0 and teng.stats["shared_page_hits"] > 0


def test_pool_exhaustion_backs_off_like_jax(setup):
    """A pool too small for the batch (3 usable pages for 4 slots):
    admission backs off and defragments, lazy growth extends — same
    tokens and counters as JAX."""
    jeng, teng = _engines(setup, slots=4, num_pages=4)
    want = _serve(jeng, _requests(JRequest, n=4, new=4))
    got = _serve(teng, _requests(Request, n=4, new=4))
    _assert_streams_equal(got, want)
    assert teng.stats == jeng.stats
    assert teng.stats["cache_exhausted"] > 0


def _run_with_pause(eng, reqs, pause_at):
    """Serve ``reqs``; at step ``pause_at`` pause, stage the device state
    to host memory, drop the engine's device state, restore it from the
    host copy and unpause."""
    for r in reqs:
        eng.submit(r)
    steps = 0
    while (eng.step() or eng.queue) and steps < 200:
        steps += 1
        if steps == pause_at:
            eng.pause()
            st = eng.export_state()
            host = dict(st, params=tree_to(st["params"], "cpu"),
                        cache=tree_to(st["cache"], "cpu", copy=True))
            eng._cache = None
            eng.import_state(host)
            eng.unpause()
    return [list(r.out) for r in reqs]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pause_round_trip_token_identical(setup, kv_dtype):
    _, _, trun, tp = setup
    kw = dict(device="cpu", slots=2, max_len=48, paged=True, page_size=8,
              kv_dtype=kv_dtype, fused_sampling=True)
    want = _run_with_pause(ServeEngine(trun, tp, **kw), _requests(Request),
                           pause_at=None)
    got = _run_with_pause(ServeEngine(trun, tp, **kw), _requests(Request),
                          pause_at=3)
    _assert_streams_equal(got, want)


def test_export_state_is_a_snapshot(setup):
    """The pools are written in place, so export_state must copy them: a
    snapshot taken mid-run stays as it was while the engine goes on."""
    _, _, trun, tp = setup
    eng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=48,
                      paged=True, page_size=8)
    for r in _requests(Request, n=2):
        eng.submit(r)
    eng.step()
    st = eng.export_state()
    assert st["params"] is eng.params and eng.dirty_keys() == set()
    before = [t.clone() for t in tree_leaves(st["cache"])]
    eng.step()
    assert eng.dirty_keys() == {"cache", "pos", "last_token"}
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(st["cache"])))
    assert not all(torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(eng._cache)))


def test_allocator_matches_jax_allocator():
    ops = [("allocate", 0, 3), ("allocate", 1, 2), ("free", 0),
           ("allocate", 2, 2), ("extend", 1, 2), ("free", 2),
           ("defragment",)]
    ja, ta = JAllocator(12, 4), BlockAllocator(12, 4)
    for op in ops:
        assert getattr(ta, op[0])(*op[1:]) == getattr(ja, op[0])(*op[1:])
        ta.check_invariants()
    assert ta.owners() == ja.owners()
    with pytest.raises(CacheExhausted):
        ta.allocate(5, 10)
    with pytest.raises(RequestRejected):
        ta.allocate(6, 12)


def test_rejections_and_paused_drain(setup):
    _, _, trun, tp = setup
    eng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=48,
                      paged=True, page_size=8)
    bad = Request(rid=0, prompt=np.arange(40) % 100, max_new_tokens=20)
    empty = Request(rid=1, prompt=np.zeros((0,), np.int32))
    good = Request(rid=2, prompt=np.arange(4) % 100, max_new_tokens=3)
    eng.pause()
    for r in (bad, empty, good):
        eng.submit(r)
    res = eng.run_until_idle()
    assert isinstance(res, DrainResult) and res == [] and not res.drained
    eng.unpause()
    res = eng.run_until_idle()
    assert res.drained and sorted(r.rid for r in res) == [0, 1, 2]
    assert "exceeds max_len" in bad.error and empty.error
    assert good.error is None and len(good.out) == 3


def test_device_defaults_to_cuda_and_raises_without_it(setup):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, _, trun, tp = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(trun, tp, paged=True)


def test_deferred_engine_parts_raise(setup):
    """No engine part is deferred any more: the dense per-slot ring is
    the default layout and serves (its parity with the JAX engine:
    ``test_torch_dense.py``), with nothing to migrate; chunked prefill
    and request migration run on the paged engine (their parity:
    ``test_torch_migration.py``)."""
    _, _, trun, tp = setup
    eng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=48)
    assert not eng.paged and not hasattr(eng, "alloc")    # dense default
    reqs = _requests(Request, n=3, new=4)
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert any(r is not None for r in eng.active)
    assert eng.peek_migratable() is None            # dense: not migratable
    assert eng.extract_request() is None
    assert eng.run_until_idle().drained
    assert all(r.done and len(r.out) == 4 for r in reqs)
    eng = ServeEngine(trun, tp, device="cpu", paged=True, prefill_chunk=4)
    assert eng.prefill_chunk == 4
    assert eng.alloc.page_size == 16
    assert eng.extract_request() is None                # idle: nothing
    assert eng.peek_migratable() is None


def test_launch_serve_bare_engine(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--paged", "--device", "cpu",
                     "--requests", "3", "--new-tokens", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["completed"] == out["requests"] == 3
    assert out["generated_tokens"] == 12
    # chunked prefill runs (prompts of 4-11 tokens, chunks of 4)
    rc = serve.main(["--smoke", "--paged", "--device", "cpu",
                     "--requests", "3", "--new-tokens", "4",
                     "--prefill-chunk", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["completed"] == 3
    assert out["generated_tokens"] == 12
    # the admission bound exists in fleet mode only: refused, not ignored
    with pytest.raises(NotImplementedError, match="--slo-max-load"):
        serve.main(["--smoke", "--device", "cpu", "--slo-max-load", "64"])


# ---------------------------------------------------------------------------
# the hybrid Mamba-attention stack (smoke twin of jamba-1.5-large-398b-1p-
# dense: one attention and three mamba layers, SSM chunk 16)
# ---------------------------------------------------------------------------
HYBRID = "jamba-1.5-large-398b-1p-dense"


@pytest.fixture(scope="module")
def hybrid():
    import dataclasses
    jrun = jax_run_config("jamba-1.5-large-398b", "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"))
    jrun = dataclasses.replace(
        jrun, model=dataclasses.replace(jrun.model, moe=None))
    trun = torch_run_config(HYBRID, "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"))
    jp = jax_model(jrun).init(jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jrun, jp, trun, tp


def _hybrid_requests(cls, n=5, new=8, shared=None):
    """As ``_requests``, with prompt lengths the SSM chunk rule admits (at
    most 16 tokens, or 32: two chunks)."""
    lens = (5, 9, 16, 32, 12, 7)
    out = []
    for i in range(n):
        prompt = (np.arange(lens[i % len(lens)]) * (i + 2) + 1) % 500
        if shared is not None:
            prompt = np.concatenate([shared, [i % 2]])
        out.append(cls(rid=i, prompt=prompt, max_new_tokens=new,
                       temperature=0.8 if i % 2 else 0.0,
                       top_k=16 if i % 4 == 1 else 0, seed=3 + i))
    return out


@pytest.mark.parametrize("kv_dtype,fused", [
    (None, True), (None, False), ("int8", True), ("int8", False)])
def test_hybrid_engine_streams_identical_to_jax(hybrid, kv_dtype, fused):
    """Paged KV for the attention layer beside dense per-slot conv and SSM
    state: the same tokens as the JAX engine, with slots recycled."""
    jeng, teng = _engines(hybrid, kv_dtype=kv_dtype, fused_sampling=fused)
    want = _serve(jeng, _hybrid_requests(JRequest))
    got = _serve(teng, _hybrid_requests(Request))
    _assert_streams_equal(got, want)
    assert teng.alloc.num_free == teng.alloc.capacity
    # every finished slot's recurrent state was zeroed
    for node in teng._cache.values():
        for name in ("conv", "ssm"):
            if name in node:
                assert torch.all(node[name] == 0), name


def test_hybrid_prefix_sharing_streams_identical_to_jax(hybrid):
    """Pairs of equal prompts share their whole prompt's pages; the
    recurrent state is still written into the sharer's slot."""
    shared = (np.arange(11) * 3) % 100
    jeng, teng = _engines(hybrid, slots=4, share_prefix=True,
                          fused_sampling=True)
    want = _serve(jeng, _hybrid_requests(JRequest, n=4, shared=shared))
    got = _serve(teng, _hybrid_requests(Request, n=4, shared=shared))
    _assert_streams_equal(got, want)
    assert teng.stats == jeng.stats
    assert teng.stats["shared_page_hits"] > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_hybrid_pause_round_trip_token_identical(hybrid, kv_dtype):
    """The staged state carries the recurrent leaves: a pause mid-run,
    with the device state dropped and restored, changes no token."""
    _, _, trun, tp = hybrid
    kw = dict(device="cpu", slots=2, max_len=48, paged=True, page_size=8,
              kv_dtype=kv_dtype, fused_sampling=True)
    want = _run_with_pause(ServeEngine(trun, tp, **kw),
                           _hybrid_requests(Request), pause_at=None)
    eng = ServeEngine(trun, tp, **kw)
    got = _run_with_pause(eng, _hybrid_requests(Request), pause_at=3)
    _assert_streams_equal(got, want)


def test_hybrid_export_state_copies_recurrent_state(hybrid):
    _, _, trun, tp = hybrid
    eng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=48,
                      paged=True, page_size=8)
    for r in _hybrid_requests(Request, n=2):
        eng.submit(r)
    eng.step()
    st = eng.export_state()
    ssm = st["cache"]["block1"]["ssm"]
    assert ssm is not eng._cache["block1"]["ssm"]
    before = ssm.clone()
    eng.step()
    assert torch.equal(ssm, before)
    assert not torch.equal(eng._cache["block1"]["ssm"], before)
    eng.import_state(st)
    assert torch.equal(eng._cache["block1"]["ssm"], before)
    assert eng._cache["block1"]["ssm"] is not ssm


def test_hybrid_inactive_slot_state_bit_untouched(hybrid):
    """A decode step with one slot masked out leaves that slot's conv and
    SSM state bytes exactly as they were (JAX's masked write-back)."""
    _, _, trun, tp = hybrid
    eng = ServeEngine(trun, tp, device="cpu", slots=3, max_len=48,
                      paged=True, page_size=8)
    for r in _hybrid_requests(Request, n=3, new=12):
        eng.submit(r)
    eng.step()
    cache = eng._cache
    rng = np.random.default_rng(0)
    for node in cache.values():
        for name in ("conv", "ssm"):
            if name in node:
                node[name][:, 1] = torch.from_numpy(rng.standard_normal(
                    tuple(node[name][:, 1].shape)).astype(np.float32))
    before = {(b, n): t.clone() for b, node in cache.items()
              for n, t in node.items()}
    act = torch.tensor([True, False, True])
    pos = torch.tensor(np.where(act.numpy(), eng.pos + 1, -1),
                       dtype=torch.int32)
    eng._decode(eng._cparams, cache,
                torch.tensor([[3], [0], [5]]), pos,
                torch.tensor(eng.tables[:, :4]), act)
    for (b, n), old in before.items():
        if n in ("conv", "ssm"):
            new = cache[b][n]
            assert torch.equal(new[:, 1].view(torch.uint8),
                               old[:, 1].view(torch.uint8)), (b, n)
            assert not torch.equal(new[:, 0], old[:, 0]), (b, n)


def test_hybrid_prefill_chunk_is_turned_off(hybrid, setup):
    """As in the JAX engine, a stack that is not all attention serves with
    chunked prefill off; an all-attention stack keeps it on."""
    _, _, trun, tp = hybrid
    eng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=48,
                      paged=True, page_size=8, prefill_chunk=8)
    assert eng.prefill_chunk == 0
    _serve(eng, _hybrid_requests(Request, n=2, new=2))
    _, _, qrun, qp = setup
    assert ServeEngine(qrun, qp, device="cpu",
                       prefill_chunk=8).prefill_chunk == 8


def test_hybrid_engine_rejects_a_prompt_breaking_the_chunk_rule(hybrid):
    """A 20-token prompt (chunk 16) cannot be scanned and is never padded:
    the request is rejected, the engine serves the others."""
    _, _, trun, tp = hybrid
    eng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=48,
                      paged=True, page_size=8)
    bad = Request(rid=0, prompt=np.arange(20) % 100, max_new_tokens=2)
    good = Request(rid=1, prompt=np.arange(32) % 100, max_new_tokens=2)
    eng.submit(bad)
    eng.submit(good)
    res = eng.run_until_idle()
    assert res.drained and "chunk rule" in bad.error
    assert good.error is None and len(good.out) == 2
    assert eng.alloc.num_free == eng.alloc.capacity


@pytest.mark.parametrize("fleet", [[], ["--fleet", "2", "--slo-max-load",
                                        "4"]], ids=["bare", "fleet"])
def test_launch_serve_hybrid_smoke(capsys, fleet):
    from repro_torch.launch import serve
    rc = serve.main(["--smoke", "--device", "cpu", "--arch", HYBRID,
                     "--requests", "3", "--new-tokens", "4"] + fleet)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["completed"] == out["requests"] == 3
    assert out["generated_tokens"] == 12
