"""The port's pipeline-parallel serving (``repro_torch.runtime.pipeline``,
``repro_torch.serve.stages``, ``repro_torch.serve.pipeline_engine``) and
its driver against the JAX package's, on the CPU.

* The schedule arithmetic (``bubble_fraction``, ``serve_schedule``,
  ``schedule_stats``) and the stage templates equal JAX's exactly.
* Each stage function at K=2, on the same inputs as JAX's stage function:
  boundary activations, last logits and the stage's cache slice within
  1e-4 (fp32 compute on both sides, the decode-step tolerance of
  ``test_torch_dense.py``); the port's stages chained give the port's
  monolithic prefill and decode step bit for bit.
* The K=4 deepseek-class engine (deepseek-67b's smoke config deepened to
  4 layers, ``slots=3``, ``max_len=64``) and the live reshape 4 -> 3 -> 2
  emit the JAX engines' token streams (fp32 compute, greedy and sampled
  requests). The JAX oracle is built with ``scan_layers=False``, as
  ``tests/test_pipeline_parallel.py`` builds it.
* Inside the port, where the arithmetic is the same: the gang's streams
  equal the single-stage paged engine's bit for bit at every K, greedy
  and sampled, bf16 and int8 KV (bf16 compute).
* ``bench.pipeline_serve --device cpu``: the rows' names and keys of the
  committed ``BENCH_pipeline_serve.json``, identities true, the modeled
  column equal to the JAX driver's.
"""
import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PrecisionConfig as JPrecision
from repro.configs import make_run_config as jax_run_config
from repro.models.model import build_model as jax_model
from repro.runtime import pipeline as jpipe
from repro.serve import paged as jpaged
from repro.serve import stages as jstages
from repro.serve.engine import Request as JRequest
from repro.serve.pipeline_engine import PipelineServeEngine as JPipeline
from repro_torch import interop
from repro_torch.bench import pipeline_serve as tbench
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import list_archs
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.models.model import build_model as torch_model
from repro_torch.runtime import pipeline as tpipe
from repro_torch.serve import paged as tpaged
from repro_torch.serve import stages as tstages
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.pipeline_engine import PipelineServeEngine
from repro_torch.tree import tree_items

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
DEEP = "deepseek-67b"


# ===========================================================================
# schedule arithmetic and templates: host code, equal to JAX's
# ===========================================================================
def test_bubble_fraction():
    assert tpipe.bubble_fraction(1, 4) == pytest.approx(3 / 4)
    assert tpipe.bubble_fraction(16, 4) == pytest.approx(3 / 19)
    assert tpipe.bubble_fraction(8, 1) == 0.0
    for m in range(1, 9):
        for s in range(1, 9):
            assert tpipe.bubble_fraction(m, s) == jpipe.bubble_fraction(m, s)


def test_build_templates_every_width_partitions():
    tpls = tstages.build_templates(12, 4)
    assert sorted(tpls) == [1, 2, 3, 4]
    for k, t in tpls.items():
        tstages.check_partition(t.bounds, 12)
        widths = [hi - lo for lo, hi in zip(t.bounds, t.bounds[1:])]
        assert len(widths) == k and sum(widths) == 12
        assert max(widths) - min(widths) <= 1   # balanced
    assert sorted(tstages.build_templates(2, 5)) == [1, 2]
    for nper in (1, 2, 4, 12, 28, 95):
        for max_k in (1, 3, 4, 8):
            got = tstages.build_templates(nper, max_k)
            want = jstages.build_templates(nper, max_k)
            assert ({k: (t.k, t.num_periods, t.bounds)
                     for k, t in got.items()}
                    == {k: (t.k, t.num_periods, t.bounds)
                        for k, t in want.items()})


@pytest.mark.parametrize("bounds,nper", [
    ((0, 2, 2, 4), 4),          # empty stage
    ((1, 4), 4),                # does not start at 0
    ((0, 3), 4)])               # does not cover the stack
def test_check_partition_rejects_bad_bounds(bounds, nper):
    with pytest.raises(ValueError):
        jstages.check_partition(bounds, nper)
    with pytest.raises(ValueError):
        tstages.check_partition(bounds, nper)
    with pytest.raises(ValueError):
        tstages.StageTemplate(k=len(bounds) - 1, num_periods=nper,
                              bounds=bounds)


def test_serve_schedule_order_and_stats():
    items = list(tpipe.serve_schedule(3, 2))
    assert sorted(items) == [(s, m) for s in range(2) for m in range(3)]
    seen = set()
    for s, m in items:
        assert s == 0 or (s - 1, m) in seen
        assert m == 0 or (s, m - 1) in seen
        seen.add((s, m))
    st = tpipe.schedule_stats([[1.0] * 4 for _ in range(2)])
    assert st.makespan == pytest.approx(5.0)
    assert st.bubble == pytest.approx(tpipe.bubble_fraction(4, 2))
    assert st.stage_busy == (4.0, 4.0)
    # the same walls give JAX's stats exactly, and the same item order
    rng = np.random.default_rng(0)
    for M in range(1, 5):
        for S in range(1, 5):
            assert (list(tpipe.serve_schedule(M, S))
                    == list(jpipe.serve_schedule(M, S)))
            walls = rng.random((S, M)).tolist()
            got, want = tpipe.schedule_stats(walls), \
                jpipe.schedule_stats(walls)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.bubble == want.bubble


def test_pipeline_supported_matches_jax():
    """Which registered architectures a gang can span: the JAX verdicts."""
    from repro.configs import get_model_config as jax_cfg
    from repro.configs import list_archs as jax_archs
    from repro_torch.configs import get_model_config as torch_cfg
    verdicts = {}
    for arch in list_archs():
        ok, _ = tstages.pipeline_supported(torch_cfg(arch))
        verdicts[arch] = ok
        if arch not in jax_archs():
            continue
        for smoke in (False, True):
            ok, why = tstages.pipeline_supported(torch_cfg(arch, smoke))
            assert (ok, why) == jstages.pipeline_supported(
                jax_cfg(arch, smoke)), arch
    assert verdicts["qwen3-0.6b"] and verdicts[DEEP]
    assert not verdicts["jamba-1.5-large-398b-1p-dense"]


# ===========================================================================
# the stage functions against JAX's (K=2, fp32 compute)
# ===========================================================================
def _runs(arch, layers=None):
    jrun = jax_run_config(arch, "decode_32k", smoke=True,
                          precision=JPrecision(compute="float32"))
    trun = torch_run_config(arch, "decode_32k", smoke=True,
                            precision=TPrecision(compute="float32"))
    if layers is not None:
        jrun = dataclasses.replace(jrun, model=dataclasses.replace(
            jrun.model, num_layers=layers))
        trun = trun.replace(model=dataclasses.replace(
            trun.model, num_layers=layers))
    # the unrolled layer program the JAX pipeline engine forces
    jrun = dataclasses.replace(jrun, sharding=dataclasses.replace(
        jrun.sharding, scan_layers=False))
    return jrun, trun


_SETUPS = {}


def _setup(arch, layers=None):
    """(jrun, JAX params, trun, port params) from the JAX init, once."""
    key = (arch, layers)
    if key not in _SETUPS:
        jrun, trun = _runs(arch, layers)
        jp = jax_model(jrun).init(jax.random.key(0))
        tp = interop.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _SETUPS[key] = (jrun, jp, trun, tp)
    return _SETUPS[key]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch,layers", [(DEEP, 4), ("qwen3-0.6b", None)])
def test_split_stage_params_matches_jax(arch, layers):
    """The same leaves as JAX's split, untied (deepseek) and tied (qwen)
    embeddings; the port's leaves are views of the tree it was given."""
    jrun, jp, trun, tp = _setup(arch, layers)
    nper = trun.model.num_layers // len(trun.model.block_pattern)
    for k, tpl in tstages.build_templates(nper, 4).items():
        jtpl = jstages.build_templates(nper, 4)[k]
        got = tstages.split_stage_params(tp, trun.model, tpl)
        want = jstages.split_stage_params(jp, jrun.model, jtpl)
        assert len(got) == len(want) == k
        for g, w in zip(got, want):
            gi, wi = list(tree_items(g)), list(tree_items(w))
            assert [p for p, _ in gi] == [p for p, _ in wi]
            for (path, a), (_, b) in zip(gi, wi):
                assert np.array_equal(_f32(a), _f32(b)), path
            for path, a in gi:
                src = tp
                for key in path:
                    src = src[key]
                assert a.untyped_storage().data_ptr() == \
                    src.untyped_storage().data_ptr(), path


def _stage_walk(pkg, run, params, prompts, page=8, K=2):
    """Per-stage prefill of each prompt (outputs of every stage), the
    stage caches stacked into a fresh paged pool, then one batched decode
    step through the stages (one slot inactive). Returns (per-stage
    prefill outputs, per-stage decode outputs, the final pool)."""
    is_jax = pkg == "jax"
    st, paged = (jstages, jpaged) if is_jax else (tstages, tpaged)
    model = jax_model(run) if is_jax else torch_model(run)
    nper = run.model.num_layers // len(run.model.block_pattern)
    tpl = st.build_templates(nper, K)[K]
    sp = st.split_stage_params(params, run.model, tpl)
    ends = [dict(first=i == 0, last=i == K - 1) for i in range(K)]
    extra = (None,) if is_jax else ()
    wrap = jax.jit if is_jax else (lambda fn: fn)
    pre = [wrap(st.make_stage_prefill(run, *extra, *tpl.stage_range(i),
                                      **ends[i])) for i in range(K)]
    dec = [wrap(st.make_stage_decode(run, *extra, *tpl.stage_range(i),
                                     **ends[i])) for i in range(K)]
    B, NP = len(prompts) + 1, 4
    shape = dataclasses.replace(run.shape, seq_len=NP * page, global_batch=B)
    kw = {} if is_jax else {"device": "cpu"}
    cache = paged.init_paged_cache(model, shape, 1 + B * NP, page, **kw)
    tables = np.zeros((B, NP), np.int32)
    pos = np.full((B,), -1, np.int32)
    pre_out = []
    for b, pr in enumerate(prompts):
        y = (jnp.asarray(pr, jnp.int32) if is_jax
             else torch.tensor(pr))[None]
        caches = []
        for i in range(K):
            y, c = pre[i](sp[i], y)
            pre_out.append(_f32(y))
            caches.append(c)
        cat = ((lambda *ls: jnp.concatenate(ls)) if is_jax
               else (lambda *ls: torch.cat(ls)))
        req = jax.tree.map(cat, *caches) if is_jax else {
            blk: {n: cat(*(c[blk][n] for c in caches)) for n in caches[0][blk]}
            for blk in caches[0]}
        pages = list(range(1 + b * NP, 1 + b * NP + NP))
        cache = paged.admit_kv(cache, req, pages[:-(-len(pr) // page)],
                               page, b)
        tables[b] = pages
        pos[b] = len(pr) - 1
    active = pos >= 0
    pos = np.where(active, pos + 1, -1).astype(np.int32)
    toks = np.where(active, 3, 0)[:, None]
    conv = (jnp.asarray if is_jax else torch.tensor)
    x = conv(toks)
    dec_out = []
    for i in range(K):
        lo, hi = tpl.stage_range(i)
        view = (jax.tree.map(lambda leaf: leaf[lo:hi], cache) if is_jax
                else {blk: {n: leaf[lo:hi] for n, leaf in node.items()}
                      for blk, node in cache.items()})
        x, nc = dec[i](sp[i], view, x, conv(pos), conv(tables),
                       conv(active))
        if is_jax:
            cache = jax.tree.map(
                lambda full, part, lo=lo, hi=hi: full.at[lo:hi].set(part),
                cache, nc)
        dec_out.append(_f32(x)[active])
    return pre_out, dec_out, cache


@pytest.mark.parametrize("arch,layers", [(DEEP, 4), ("qwen3-0.6b", None)])
def test_stage_functions_match_jax(arch, layers):
    """make_stage_prefill and make_stage_decode at K=2, every stage, on
    the same prompts: boundary activations, last logits and the pool the
    stages wrote within TOL of JAX's stage functions."""
    jrun, jp, trun, tp = _setup(arch, layers)
    prompts = [list(range(3, 14)), [5, 9, 2, 2, 7, 31, 400, 8]]
    jpre, jdec, jcache = _stage_walk("jax", jrun, jp, prompts)
    tpre, tdec, tcache = _stage_walk("torch", trun, tp, prompts)
    for i, (g, w) in enumerate(zip(tpre + tdec, jpre + jdec)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                   err_msg=f"output {i}")
    for (path, a), (_, b) in zip(tree_items(jcache), tree_items(tcache)):
        np.testing.assert_allclose(_f32(b), _f32(a), atol=TOL, rtol=TOL,
                                   err_msg=str(path))


def test_stages_chained_equal_the_monolithic_model():
    """Inside the port: the K=2 stages chained give ``Model.prefill``'s
    last logits and cache and ``Model.decode_step``'s logits bit for bit
    (the same ops in the same order over the same views)."""
    _, _, trun, tp = _setup(DEEP, 4)
    model = torch_model(trun)
    prompt = torch.tensor([list(range(3, 14))])
    want_cache, want = model.prefill(tp, {"tokens": prompt})
    tpl = tstages.build_templates(4, 2)[2]
    sp = tstages.split_stage_params(tp, trun.model, tpl)
    y, c0 = tstages.make_stage_prefill(trun, 0, 2, first=True,
                                       last=False)(sp[0], prompt)
    got, c1 = tstages.make_stage_prefill(trun, 2, 4, first=False,
                                         last=True)(sp[1], y)
    assert torch.equal(got, want)
    for name in ("k", "v"):
        assert torch.equal(torch.cat([c0["block0"][name],
                                      c1["block0"][name]]),
                           want_cache["block0"][name])


# ===========================================================================
# the K-VF engine against the JAX engine (fp32 compute)
# ===========================================================================
def _mkreqs(cls, n=3, max_new=6):
    """The JAX test's prompts; odd rids sample (temperature 0.8, top-k 16
    on rid 1), even rids are greedy."""
    prompts = [np.arange(4) % 97, (np.arange(7) * 3) % 97,
               (np.arange(5) * 5 + 2) % 97, (np.arange(6) * 7 + 1) % 97]
    return [cls(rid=i, prompt=np.asarray(prompts[i % 4], np.int32),
                max_new_tokens=max_new,
                temperature=0.8 if i % 2 else 0.0,
                top_k=16 if i % 4 == 1 else 0, seed=5 + i)
            for i in range(n)]


def _drive(eng, reqs, hook=None):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while (eng.step() or eng.queue) and steps < 200:
        steps += 1
        if hook is not None:
            hook(steps)
    assert all(r.done for r in reqs), [r.rid for r in reqs if not r.done]
    return [list(r.out) for r in reqs]


def _reshape_hook(eng):
    def hook(step):
        if step == 3:
            eng.apply_reshape(3)
        elif step == 6:
            eng.apply_reshape(2)
    return hook


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX engines' streams: the K=4 gang, and the gang reshaped 4 ->
    3 -> 2 mid-decode (8 new tokens)."""
    jrun, jp, _, _ = _setup(DEEP, 4)
    out = {}
    gang = JPipeline(jrun, jp, stages=4, microbatches=2, slots=3,
                     max_len=64)
    out["k4"] = _drive(gang, _mkreqs(JRequest))
    out["k4_sched_ticks"] = gang.sched_ticks
    gang = JPipeline(jrun, jp, stages=4, microbatches=2, slots=3,
                     max_len=64)
    out["reshape"] = _drive(gang, _mkreqs(JRequest, max_new=8),
                            hook=_reshape_hook(gang))
    return out


def test_pipeline_k4_serves_deepseek_class_like_jax(jax_streams):
    _, _, trun, tp = _setup(DEEP, 4)
    gang = PipelineServeEngine(trun, tp, device="cpu", stages=4,
                               microbatches=2, slots=3, max_len=64)
    assert gang.stage_width == 4 and gang.max_stage_width == 4
    assert gang.stage_bounds() == (0, 1, 2, 3, 4)
    got = _drive(gang, _mkreqs(Request))
    assert got == jax_streams["k4"]
    assert gang.sched_ticks == jax_streams["k4_sched_ticks"]
    loads = gang.stage_loads()
    assert len(loads) == 4 and all(0.0 <= x <= 1.0 for x in loads)
    assert 0.0 <= gang.measured_bubble < 1.0


def test_live_reshape_k4_to_k3_to_k2_like_jax(jax_streams):
    _, _, trun, tp = _setup(DEEP, 4)
    gang = PipelineServeEngine(trun, tp, device="cpu", stages=4,
                               microbatches=2, slots=3, max_len=64)
    got = _drive(gang, _mkreqs(Request, max_new=8),
                 hook=_reshape_hook(gang))
    assert got == jax_streams["reshape"]
    assert gang.stage_width == 2 and gang.reshape_count == 2
    assert gang.stage_bounds() == gang.templates[2].bounds == (0, 2, 4)
    oracle = ServeEngine(trun, tp, device="cpu", slots=3, max_len=64,
                         paged=True)
    assert got == _drive(oracle, _mkreqs(Request, max_new=8))


def test_pipeline_engine_refusals_match_jax():
    jrun, jp, trun, tp = _setup(DEEP, 4)
    for kw in ({"fused_sampling": True}, {"prefill_chunk": 4},
               {"stages": 5}):
        with pytest.raises(ValueError):
            JPipeline(jrun, jp, slots=2, max_len=32, **kw)
        with pytest.raises(ValueError):
            PipelineServeEngine(trun, tp, device="cpu", slots=2,
                                max_len=32, **kw)
    gang = PipelineServeEngine(trun, tp, device="cpu", stages=2, slots=2,
                               max_len=32, max_stages=3)
    assert gang.paged and sorted(gang.templates) == [1, 2, 3]
    with pytest.raises(ValueError, match="K=4"):
        gang.apply_reshape(4)
    hrun = torch_run_config("jamba-1.5-large-398b-1p-dense", "decode_32k",
                            smoke=True)
    with pytest.raises(ValueError, match="not all-attn"):
        PipelineServeEngine(hrun, None, device="cpu")


def test_stage_views_are_dropped_with_the_device_state():
    """The stage params are views of the compute copy, made once per
    width; dropping the engine's device state, a params import and a
    reshape each drop them (a paused engine's views pin nothing)."""
    _, _, trun, tp = _setup(DEEP, 4)
    gang = PipelineServeEngine(trun, tp, device="cpu", stages=2, slots=2,
                               max_len=32)
    _drive(gang, _mkreqs(Request, n=2, max_new=3))
    sp = gang._sparams
    assert sp is not None and gang._stage_param_slices() is sp
    leaf = sp[1]["decoder"]["layers"]["block0"]["wq"]
    base = gang._cparams["decoder"]["layers"]["block0"]["wq"]
    assert leaf.untyped_storage().data_ptr() == \
        base.untyped_storage().data_ptr()
    st = gang.export_state()
    gang.drop_device_state()
    assert gang._sparams is None and gang._cparams is None
    gang.import_state(st)
    assert gang._sparams is None
    gang._stage_param_slices()
    gang.apply_reshape(1)
    assert gang._sparams is None


# ===========================================================================
# inside the port: the gang equals the single-stage engine bit for bit
# ===========================================================================
_BF16 = {}


def _bf16_setup():
    """deepseek-class 4 layers at the default bf16 compute, port init."""
    if not _BF16:
        run = torch_run_config(DEEP, "decode_32k", smoke=True)
        run = run.replace(model=dataclasses.replace(run.model,
                                                    num_layers=4))
        _BF16["run"] = run
        _BF16["params"] = torch_model(run).init(seed=3, device="cpu")
    return _BF16["run"], _BF16["params"]


def _oracle_bf16(kv):
    key = ("oracle", kv)
    if key not in _BF16:
        run, params = _bf16_setup()
        _BF16[key] = _drive(ServeEngine(run, params, device="cpu", slots=3,
                                        max_len=64, paged=True,
                                        kv_dtype=kv),
                            _mkreqs(Request, n=5, max_new=5))
    return _BF16[key]


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_gang_equals_single_stage_engine(k, kv):
    run, params = _bf16_setup()
    gang = PipelineServeEngine(run, params, device="cpu", stages=k,
                               microbatches=2, slots=3, max_len=64,
                               kv_dtype=kv)
    assert _drive(gang, _mkreqs(Request, n=5, max_new=5)) == \
        _oracle_bf16(kv)


# ===========================================================================
# the driver
# ===========================================================================
def _jax_bench_module():
    spec = importlib.util.spec_from_file_location(
        "jax_pipeline_serve", ROOT / "benchmarks" / "pipeline_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pipeline_serve_bench(capsys, tmp_path):
    out = tmp_path / "p.json"
    assert tbench.main(["--device", "cpu", "--out", str(out)]) in (0, 1)
    rows = json.loads(out.read_text())
    want = json.loads((ROOT / "BENCH_pipeline_serve.json").read_text())
    assert [r["name"] for r in rows] == [r["name"] for r in want]
    for g, w in zip(rows, want):
        assert set(w) <= set(g), g["name"]
    summary = rows[-1]
    assert tbench.identities_hold(summary)
    jb = _jax_bench_module()
    assert (tbench.BUBBLE_SLACK, tbench.RESHAPE_STALL_RATIO) == \
        (jb.BUBBLE_SLACK, jb.RESHAPE_STALL_RATIO)
    by = {r["name"]: r for r in rows}
    assert by["modeled_full_config"]["tokens_per_s_ratio"] == {
        str(k): v for k, v in jb.modeled_scaling(95, (1, 2, 3, 4), 4).items()}
    assert by["modeled_full_config"] == next(
        r for r in want if r["name"] == "modeled_full_config")
    assert by["oracle_k1"]["tokens"] == 18
    assert "summary" in capsys.readouterr().out
