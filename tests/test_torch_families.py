"""Every model family of the JAX package through the port, on the CPU at
smoke widths: the registry, param trees and counts, interop, the data
pipeline's patches and frames, the loss and its metrics, prefill and
and per-slot decode logits, each against the JAX package on the same
weights (the JAX init, converted) and the same numpy inputs; the serve
engine's token streams are in ``tests/test_torch_families_serve.py``.

The families: the dense llama3-8b, phi3-mini-3.8b (head dim 96 at full
width) and deepseek-67b; the MoE olmoe-1b-7b and arctic-480b (a dense
residual beside the experts); xlstm-350m (mLSTM and sLSTM, no
attention); seamless-m4t-medium (encoder-decoder, random or zero
frames); internvl2-1b (vision patches before the text); and the full
jamba-1.5-large-398b (mamba with MoE on every other layer).

Tolerances: 1e-4 at fp32 on logits, losses and cache leaves of magnitude
~1 (the frameworks sum in other orders, amplified through the layers;
``tests/test_torch_model.py``); 5e-2 at bf16 (activations rounded to
bf16 after every matmul, JAX through its Pallas kernels in interpret
mode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PrecisionConfig as JPrecision
from repro.configs import get_model_config as jax_model_config
from repro.configs import list_archs as jax_archs
from repro.configs import make_run_config as jax_run_config
from repro.data.pipeline import SyntheticSource as JSource
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import params as jparams
from repro.models.model import build_model as jax_model
from repro_torch import interop
from repro_torch.configs import PrecisionConfig as TPrecision
from repro_torch.configs import get_model_config as torch_model_config
from repro_torch.configs import list_archs as torch_archs
from repro_torch.configs import make_run_config as torch_run_config
from repro_torch.data.pipeline import SyntheticSource as TSource
from repro_torch.kernels import ops
from repro_torch.models import params as tparams
from repro_torch.models.model import build_model as torch_model
from repro_torch.serve.paged import paged_cache_supported
from repro_torch.tree import tree_items

FAMILIES = ["llama3-8b", "phi3-mini-3.8b", "deepseek-67b", "olmoe-1b-7b",
            "arctic-480b", "xlstm-350m", "seamless-m4t-medium",
            "internvl2-1b", "jamba-1.5-large-398b"]
PAGED = [a for a in FAMILIES
         if paged_cache_supported(torch_model_config(a, smoke=True))[0]]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_SETUPS = {}


def _setup(arch, compute="float32", jax_backend="reference"):
    """(jrun, JAX params, trun, port params) at smoke size."""
    key = (arch, compute, jax_backend)
    if key not in _SETUPS:
        jrun = jax_run_config(arch, "train_4k", smoke=True,
                              precision=JPrecision(compute=compute),
                              kernel_backend=jax_backend)
        trun = torch_run_config(arch, "train_4k", smoke=True,
                                precision=TPrecision(compute=compute))
        jp = _SETUPS.get((arch, "params"))
        if jp is None:
            jp = _SETUPS[(arch, "params")] = jax_model(jrun).init(
                jax.random.key(0))
        tp = interop.params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _SETUPS[key] = (jrun, jp, trun, tp)
    return _SETUPS[key]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# registry, params, interop, data
# ---------------------------------------------------------------------------
def test_registry_holds_every_jax_arch():
    """The port registers every architecture of the JAX package, plus its
    two one-card variants."""
    assert set(jax_archs()) <= set(torch_archs())
    assert set(torch_archs()) - set(jax_archs()) == {
        "jamba-1.5-large-398b-1p-dense", "arctic-480b-1l"}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_shapes_and_count_match_jax(arch, smoke):
    """Leaf paths, shapes and dtypes (the fp32 router and mLSTM gate
    projections among bf16 leaves), total and active parameter counts."""
    jc, tc = jax_model_config(arch, smoke=smoke), torch_model_config(
        arch, smoke=smoke)
    want = {p: (tuple(s.shape), np.dtype(s.dtype).name) for p, s in
            tree_items(jparams.param_shapes(jc, jnp.bfloat16))}
    got = {p: (s.shape, str(s.dtype).removeprefix("torch."))
           for p, s in tree_items(tparams.param_shapes(tc, torch.bfloat16))}
    assert got == want
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


def test_one_card_variants():
    """arctic-480b-1l: the published widths at one layer, bf16 params
    (the 30 B line would give fp32); olmoe-1b-7b stays fp32."""
    arctic = torch_run_config("arctic-480b-1l", "decode_32k")
    full = torch_model_config("arctic-480b")
    assert arctic.model.num_layers == 1
    assert dataclasses.replace(arctic.model, num_layers=35,
                               name=full.name) == full
    assert arctic.precision.params == "bfloat16"
    assert arctic.model.param_count() == 14_069_945_344
    olmoe = torch_run_config("olmoe-1b-7b", "decode_32k")
    assert olmoe.precision.params == "float32"
    assert olmoe.model.param_count() == 6_919_100_416


@pytest.mark.parametrize("arch", FAMILIES)
def test_interop_round_trips_every_leaf(arch):
    """Every leaf (routers, experts, mLSTM/sLSTM, encoder and cross
    leaves) crosses to the port and back bit for bit, fp32 and bf16."""
    _, jp, _, tp = _setup(arch)
    for tree in (jp, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16)
                                  if a.dtype != jnp.float32 or a.ndim > 1
                                  else a, jp)):
        want = dict(tree_items(jax.tree.map(np.asarray, tree)))
        back = dict(tree_items(interop.params_to_jax(
            interop.params_from_jax(jax.tree.map(np.asarray, tree),
                                    device="cpu"))))
        assert back.keys() == want.keys()
        for path, leaf in want.items():
            assert back[path].dtype == leaf.dtype, path
            assert np.array_equal(back[path].view(np.uint8),
                                  leaf.view(np.uint8)), path


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_pipeline_patches_and_frames_match_jax(arch):
    """The synthetic batches carry the JAX pipeline's patches or frames,
    bit for bit."""
    jrun, _, trun, _ = _setup(arch)
    for step in (0, 3):
        want = JSource(jrun, batch_override=2, seq_override=32).batch_at(step)
        got = TSource(trun, batch_override=2, seq_override=32).batch_at(step)
        assert got.keys() == want.keys()
        assert {"patches", "frames"} & set(got)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b",
                                  "olmoe-1b-7b"])
def test_input_specs_match_jax(arch, kind):
    jrun, _, trun, _ = _setup(arch)
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    want = jax_model(jax_run_config(arch, shape, smoke=True)).input_specs()
    got = torch_model(torch_run_config(arch, shape, smoke=True)).input_specs()
    assert {k: (tuple(s.shape), np.dtype(s.dtype).name)
            for k, s in want.items()} == \
        {k: (s.shape, str(s.dtype).removeprefix("torch."))
         for k, s in got.items()}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_metrics_match_jax(arch):
    """The train-mode loss and every metric (ce, ntok, the aux losses) at
    fp32 on the pipeline's batch (random patches / frames where the
    family takes them)."""
    jrun, jp, trun, tp = _setup(arch)
    b = JSource(jrun, batch_override=2, seq_override=32).batch_at(1)
    _, jm = jax.jit(jax_model(jrun).loss)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        _, tm = torch_model(trun).loss(tp, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _prompt_batch(jrun, L, seed):
    """A B=1 prefill batch of L tokens with random patches / frames."""
    cfg = jrun.model
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (1, L)).astype(np.int32)}
    if cfg.frontend.kind == "vision":
        b["patches"] = rng.standard_normal(
            (1, cfg.frontend.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = rng.standard_normal(
            (1, max(1, L // cfg.frontend.frame_ratio),
             cfg.d_model)).astype(np.float32)
    return b


def _close_trees(got, want, msg, tol):
    """Leaf by leaf, matched by path (JAX sorts dict keys)."""
    want = dict(tree_items(want))
    got = dict(tree_items(got))
    assert got.keys() == want.keys()
    for path, a in want.items():
        _close(got[path], a, tol, f"{msg} {path}")


def _ring_insert(ring, cache, b, L):
    """Write a B=1 prefill cache (numpy tree) into slot b of a ring."""
    for path, leaf in tree_items(cache):
        node = ring
        for k in path[:-1]:
            node = node[k]
        if path[-1] in ("k", "v", "xk", "xv"):
            node[path[-1]][:, b, :leaf.shape[2]] = leaf[:, 0]
        else:
            node[path[-1]][:, b] = leaf[:, 0]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_per_slot_decode_match_jax(arch, compute):
    """Three slots prefilled (B=1 each, as the engine does: 5, 16 and 32
    tokens, random patches / frames) into a dense ring of 48 rows past the
    patches; three decode steps at per-slot positions with slot 1
    inactive. Prefill logits, decode logits of the active rows and every
    cache leaf within 1e-4 of JAX at fp32, 5e-2 at bf16 (JAX through its
    Pallas kernels in interpret mode, op by op: see the bf16 prefill
    test)."""
    bf16 = compute == "bfloat16"
    jrun, jp, trun, tp = _setup(arch, compute,
                                "pallas" if bf16 else "reference")
    tol = TOL[compute]
    cfg = trun.model
    jm, tm = jax_model(jrun), torch_model(trun)
    jprefill, jdecode = ((jm.prefill, jm.decode_step) if bf16 else
                         (jax.jit(jm.prefill), jax.jit(jm.decode_step)))
    params = tm.compute_params(tp)
    npatch = cfg.frontend.num_patches if cfg.frontend.kind == "vision" else 0
    lens, T = (5, 16, 32), 48 + npatch
    shape = dataclasses.replace(trun.shape, seq_len=T, global_batch=3)
    # the ring as numpy (bf16 leaves through ml_dtypes), filled from JAX's
    # prefills, then handed to both packages
    tree = interop.params_to_jax(tm.init_cache(shape, device="cpu"))
    for b, L in enumerate(lens):
        batch = _prompt_batch(jrun, L, seed=b)
        jc, jl = jprefill(jp, {k: jnp.asarray(v) for k, v in
                               batch.items()})
        with torch.no_grad():
            tc, tl = tm.prefill(params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        _close(tl, jl, tol, f"prefill logits, slot {b}")
        _close_trees(tc, jc, f"prefill cache, slot {b}", tol)
        _ring_insert(tree, jax.tree.map(np.asarray, jc), b, L)
    jring = jax.tree.map(jnp.asarray, tree)
    tring = interop.params_from_jax(tree, device="cpu")
    active = np.array([True, False, True])
    rng = np.random.default_rng(7)
    for step in range(3):
        pos = np.where(active, npatch + np.array(lens) + step,
                       -1).astype(np.int32)
        toks = rng.integers(0, cfg.vocab_size, (3, 1))
        jl, jring = jdecode(jp, jring, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(pos), active=jnp.asarray(active))
        with torch.no_grad():
            tl, tring = tm.decode_step(params, tring, torch.tensor(toks),
                                       torch.tensor(pos),
                                       active=torch.tensor(active))
        _close(tl[torch.tensor(active)], np.asarray(jl)[active], tol,
               f"decode logits, step {step}")
    _close_trees(tring, jring, "ring", tol)
    for path, a in tree_items(tree):           # slot 1 never written
        node = tring
        for k in path:
            node = node[k]
        assert np.array_equal(_f32(node)[:, 1], _f32(a)[:, 1]), path


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_prefill_logits_match_jax(arch):
    """Prefill logits at bf16 compute (JAX through its Pallas kernels in
    interpret mode) within 5e-2."""
    jrun, jp, trun, tp = _setup(arch, "bfloat16", "pallas")
    batch = _prompt_batch(jrun, 16, seed=3)
    # op by op, as the JAX package's own bf16 parity tests run it (under
    # jit, XLA keeps some of xLSTM's bf16 intermediates in fp32)
    _, jl = jax_model(jrun).prefill(jp, {k: jnp.asarray(v) for k, v in
                                         batch.items()})
    with torch.no_grad():
        _, tl = torch_model(trun).prefill(
            torch_model(trun).compute_params(tp),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, TOL["bfloat16"])


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_frontend_forward_logits_match_jax(arch):
    """The whole-sequence forward's logits (every position, patch rows
    included) with random frames / patches at fp32, and at bf16 against
    JAX's Pallas path; the encoder's memory changes the decoder's logits
    (zero frames give other logits than random ones)."""
    jrun, jp, trun, tp = _setup(arch)
    rng = np.random.default_rng(4)
    b = JSource(jrun, batch_override=2, seq_override=16).batch_at(2)
    b.pop("labels")
    jl, _, _ = jax_model(jrun).forward(jp, {k: jnp.asarray(v) for k, v in
                                            b.items()})
    with torch.no_grad():
        tl, _, _ = torch_model(trun).forward(
            tp, {k: torch.from_numpy(v) for k, v in b.items()})
        assert tl.shape == jl.shape
        _close(tl, jl, TOL["float32"])
        other = {k: torch.from_numpy(v) for k, v in b.items()}
        key = "frames" if "frames" in b else "patches"
        other[key] = torch.from_numpy(rng.standard_normal(
            b[key].shape).astype(np.float32))
        tl2, _, _ = torch_model(trun).forward(tp, other)
    assert float((tl2 - tl).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# flash_attention at head dim 96 (phi3-mini-3.8b)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,H,K,causal", [
    (128, 128, 4, 4, True),      # phi3: MHA (G = 1), causal prefill
    (64, 64, 8, 1, False),       # G = 8, non-causal (the encoder)
    (32, 16, 4, 4, False),       # cross attention: T = S / 2
])
def test_flash_attention_hd96_plain_matches_pallas(S, T, H, K, causal,
                                                   dtype):
    """The port's flash_attention (its plain version on the CPU) at head
    dim 96 against JAX's Pallas kernel in interpret mode (2e-5 at fp32,
    2e-2 at bf16: ``tests/test_torch_kernels.py``'s bounds)."""
    rng = np.random.default_rng(S + T)
    qn = rng.standard_normal((1, S, H, 96), np.float32)
    kn, vn = (rng.standard_normal((1, T, K, 96), np.float32) for _ in "kv")
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = pallas_flash(*(jnp.asarray(a).astype(jdt) for a in (qn, kn, vn)),
                        causal=causal, interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (qn, kn, vn)), causal=causal)
    assert got.dtype == tdt and got.shape == (1, S, H, 96)
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got, want, tol)


def test_prefill_chunk_takes_decoder_only_attention_stacks():
    """A chunk of a chunked prefill needs a decoder-only all-attention
    stack: the xLSTM stack and the encoder-decoder raise ValueError (the
    JAX method fails on both); a vision model's chunk (no patches, as in
    JAX) gives JAX's logits at fp32."""
    for arch in ("xlstm-350m", "seamless-m4t-medium"):
        _, _, trun, tp = _setup(arch)
        model = torch_model(trun)
        cache = model.init_cache(dataclasses.replace(
            trun.shape, seq_len=16, global_batch=1), device="cpu")
        with pytest.raises(ValueError, match="decoder-only"):
            model.prefill_chunk(tp, cache, torch.zeros((1, 4),
                                                       dtype=torch.int64),
                                torch.tensor(0))
    jrun, jp, trun, tp = _setup("internvl2-1b")
    jm, tm = jax_model(jrun), torch_model(trun)
    shape = dataclasses.replace(trun.shape, seq_len=16, global_batch=1)
    jc, tc = jm.init_cache(shape), tm.init_cache(shape, device="cpu")
    toks = np.random.default_rng(6).integers(0, 512, (1, 8))
    for off in (0, 8):
        chunk = toks[:, off:off + 4]
        jc, jl = jm.prefill_chunk(jp, jc, jnp.asarray(chunk, jnp.int32),
                                  jnp.int32(off))
        with torch.no_grad():
            tc, tl = tm.prefill_chunk(tp, tc, torch.tensor(chunk),
                                      torch.tensor(off))
        _close(tl, jl, TOL["float32"], f"chunk at {off}")
