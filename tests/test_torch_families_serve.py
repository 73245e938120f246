"""The serve engine of every model family against the JAX package's, on
the CPU at smoke widths (the families and weights of
``tests/test_torch_families.py``): token streams of mixed greedy and
sampled requests, equal at fp32 compute on the dense ring and, where the
family has pages, the paged bf16 and int8 pools; and the engine's gates
(chunked prefill, prefix sharing, paged KV) for the encoder-decoder, the
vision model and the recurrent stack.
"""
import numpy as np
import pytest

from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged import paged_cache_supported
from test_torch_families import FAMILIES, PAGED, _setup


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------
def _requests(cls, arch):
    """Five requests, greedy and sampled (temperature 0.8, top-k 0 or 16)
    mixed, of prompt lengths every family's rules admit."""
    return [cls(rid=i, prompt=(np.arange(n) * (i + 2) + 1) % 500,
                max_new_tokens=8, temperature=0.8 if i % 2 else 0.0,
                top_k=16 if i % 4 == 1 else 0, seed=3 + i)
            for i, n in enumerate((4, 16, 9, 32, 12))]


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    assert engine.run_until_idle().drained
    assert all(r.done and r.error is None for r in reqs)
    return [list(r.out) for r in reqs]


@pytest.mark.parametrize("arch,layout", [(a, "dense") for a in FAMILIES]
                         + [(a, "paged") for a in PAGED]
                         + [("olmoe-1b-7b", "int8"),
                            ("internvl2-1b", "int8")])
def test_engine_streams_match_jax(arch, layout):
    """Five requests through two slots (slots recycled, decode with an
    inactive slot): the port's engine gives the JAX engine's tokens at
    fp32 compute, on the dense ring and, where the family has pages, the
    paged bf16 and int8 pools; fused sampling on the device."""
    jrun, jp, trun, tp = _setup(arch)
    kw = dict(slots=2, max_len=64, fused_sampling=True)
    if layout != "dense":
        kw.update(paged=True, kv_dtype="int8" if layout == "int8" else None)
    jeng = JEngine(jrun, jp, **kw)
    want = _serve(jeng, _requests(JRequest, arch))
    teng = ServeEngine(trun, tp, device="cpu", **kw)
    assert _serve(teng, _requests(Request, arch)) == want
    assert teng.stats == jeng.stats


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b",
                                  "xlstm-350m"])
def test_engine_gates_like_jax(arch):
    """Chunked prefill is off for an encoder-decoder, a vision model and a
    recurrent stack; prefix sharing off for vision; paged KV refused for
    the encoder-decoder and the attention-free stack; a vision request's
    logical length counts its patches."""
    jrun, jp, trun, tp = _setup(arch)
    teng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=64,
                       prefill_chunk=4)
    jeng = JEngine(jrun, jp, slots=2, max_len=64, prefill_chunk=4)
    assert teng.prefill_chunk == jeng.prefill_chunk == 0
    ok, why = paged_cache_supported(trun.model)
    if not ok:
        with pytest.raises(ValueError, match=why):
            ServeEngine(trun, tp, device="cpu", paged=True)
        return
    peng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=64,
                       paged=True, share_prefix=True)
    assert not peng.share_prefix
    req = Request(rid=0, prompt=np.arange(5), max_new_tokens=3)
    peng.submit(req)
    peng.step()
    npatch = trun.model.frontend.num_patches
    assert int(peng.pos[0]) == npatch + 5         # prefill + one decode
    too_long = Request(rid=1, prompt=np.arange(64 - npatch - 2),
                       max_new_tokens=4)
    peng.submit(too_long)
    peng.run_until_idle()
    assert "exceeds max_len" in too_long.error


@pytest.mark.parametrize("arch,chunk,want", [("olmoe-1b-7b", 0, 5),
                                             ("olmoe-1b-7b", 8, 11),
                                             ("xlstm-350m", 0, 5)])
def test_engine_counts_prefill_calls(arch, chunk, want):
    """``ServeEngine.prefill_calls`` counts the prefills the engine ran, a
    whole prompt's or one chunk's (prompts of 4, 16, 9, 32 and 12 tokens
    in chunks of 8: 1 + 2 + 2 + 4 + 2), and no decode step: a caller
    tells a decode-only step by it, an attention-free stack's too."""
    _, _, trun, tp = _setup(arch)
    eng = ServeEngine(trun, tp, device="cpu", slots=2, max_len=64,
                      prefill_chunk=chunk)
    _serve(eng, _requests(Request, arch))
    assert eng.prefill_calls == want
