"""The port's serve-plane benchmarks and ``runtime.roofline``
against the JAX package's, on the CPU at smoke sizes.

``kernel_roofline`` and ``model_flops_estimate`` equal the JAX
functions on the same inputs; ``Peaks()`` is the card's data sheet, not
the TPU figures of the JAX defaults. Each benchmark's rows carry the names
and keys of the JAX benchmark's committed JSON (read, never rerun), and
its deterministic gates hold: ``prefix_share``'s page accounting and
token identity (the committed page counts too), ``serve_path``'s two
fused-sampling bit identities, ``decode_roofline``'s byte ratio (and its
analytic FLOPs and bytes at fp32 equal the committed rows'). The
throughput benchmark's keys, and its snapshot byte counts, equal the JAX
``bench(steps=2)``'s, run in a subprocess with the eight CPU devices the
JAX benchmark asks for.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_model_config as jax_model_config
from repro.configs.base import SHAPES as JSHAPES
from repro.models.model import build_model as jax_model
from repro.runtime import roofline as jroof
from repro.serve.paged import init_paged_cache as jax_paged_cache
from repro_torch.bench import decode_roofline, prefix_share, serve_path
from repro_torch.bench import throughput
from repro_torch.configs import get_model_config as torch_model_config
from repro_torch.configs import make_run_config
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models.model import build_model
from repro_torch.runtime import roofline as troof

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _committed(name):
    return {r["name"]: r for r in json.loads(
        (ROOT / f"BENCH_{name}.json").read_text())}


def _quiet(*_):
    pass


# ---------------------------------------------------------------------------
# runtime.roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flops,nbytes,wall", [
    (3.3e7, 3.4e7, 1.2e-2), (5.0e10, 1.0e6, 2.0e-3), (1.0, 0.0, 0.0)])
def test_kernel_roofline_matches_jax(flops, nbytes, wall):
    tp = troof.Peaks(flops=1.2e11, hbm_bw=4.6e9, ici_bw=5e10)
    jp = jroof.Peaks(flops=1.2e11, hbm_bw=4.6e9, ici_bw=5e10)
    assert tp.row() == jp.row()
    got = troof.kernel_roofline("k", flops, nbytes, wall, peaks=tp)
    want = jroof.kernel_roofline("k", flops, nbytes, wall, peaks=jp)
    assert got == want


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "svff-bench",
                                  "jamba-1.5-large-398b-1p-dense"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_model_flops_estimate_matches_jax(arch, shape):
    tcfg = torch_model_config(arch)
    if arch.endswith("-1p-dense"):
        # the JAX twin: one period of the full config, experts dropped
        jcfg = jax_model_config("jamba-1.5-large-398b")
        jcfg = dataclasses.replace(jcfg, moe=None,
                                   num_layers=tcfg.num_layers)
    else:
        jcfg = jax_model_config(arch)
    got = troof.model_flops_estimate(tcfg, TSHAPES[shape])
    assert got == jroof.model_flops_estimate(jcfg, JSHAPES[shape])
    assert got > 0


def test_peaks_defaults_are_the_cards_not_tpu_figures():
    p = troof.Peaks()
    tpu = jroof.Peaks()                       # the JAX defaults (v5e)
    assert (p.flops, p.hbm_bw, p.ici_bw) == (989e12, 3.35e12, 900e9)
    assert not {p.flops, p.hbm_bw, p.ici_bw} & {tpu.flops, tpu.hbm_bw,
                                                  tpu.ici_bw}
    assert troof.DEFAULT_PEAKS == p
    assert set(p.row()) == set(tpu.row())
    m = troof.measure_local_peaks(copy_mb=4.0, reps=1, device="cpu")
    assert m.flops > 0 and m.hbm_bw > 0 and m.ici_bw == p.ici_bw


# ---------------------------------------------------------------------------
# decode_roofline
# ---------------------------------------------------------------------------
def test_decode_roofline_rows_and_byte_gate():
    rows, ok = decode_roofline.bench(reduced=True, reps=1, device="cpu",
                                     log=_quiet)
    want = _committed("decode_roofline")
    assert [r["name"] for r in rows] == list(want)
    for r in rows[:-1]:
        # the port records the dtype each row ran at, beside JAX's keys
        assert set(r) == set(want[r["name"]]) | {"dtype"}, r["name"]
        assert r["wall_s"] > 0
    assert set(rows[-1]) == set(want["summary"])
    assert {r["name"]: r["dtype"] for r in rows[:-1]} == {
        "flash_decode": "float32", "paged_fp": "float32",
        "paged_int8": "int8", "fused_sample": "float32",
        "ssm_scan": "float32"}
    s = rows[-1]
    assert s["rows_present"] == 5 and s["reduced"] is True
    assert s["int8_bytes_vs_fp"] <= 0.6
    assert ok == (s["int8_wall_vs_fp"] <= 2.5)
    # counted at fp32, the analytic work is the JAX benchmark's
    for name, (flops, nbytes) in decode_roofline.work(
            decode_roofline.shapes(False), 4).items():
        assert (flops, nbytes) == (want[name]["flops"], want[name]["bytes"])


# ---------------------------------------------------------------------------
# prefix_share
# ---------------------------------------------------------------------------
def test_prefix_share_rows_and_gates():
    rows = prefix_share.bench(smoke=True, device="cpu", log=_quiet)
    want = _committed("prefix_share")
    assert [r["name"] for r in rows] == list(want)
    for r in rows:
        assert set(r) == set(want[r["name"]]), r["name"]
    s = rows[-1]
    assert s["capacity_ratio"] >= 3.0 and s["outputs_bit_identical"]
    assert prefix_share.gates_hold(s)
    # page accounting is deterministic: the JAX benchmark's numbers
    for name in ("copy_on_admit", "prefix_share"):
        for key in ("peak_pages_at_full_residency", "shared_page_hits",
                    "cow_splits", "generated_tokens"):
            assert rows[[r["name"] for r in rows].index(name)][key] == \
                want[name][key], (name, key)


# ---------------------------------------------------------------------------
# serve_path
# ---------------------------------------------------------------------------
def test_serve_path_rows_and_identities():
    rows = serve_path.bench(requests=4, slots=2, max_len=64, page_size=16,
                            max_new=6, smoke=True, device="cpu", log=_quiet)
    want = _committed("serve_path")
    assert [r["name"] for r in rows] == list(want)
    for r in rows:
        assert set(r) == set(want[r["name"]]), r["name"]
    s = rows[-1]
    assert serve_path.identities_hold(s)
    assert s["fused_bit_identical"] and s["fused_int8_bit_identical"]
    assert s["paged16_baseline_tokens_per_s"] == serve_path.PAGED16_BASELINE
    assert set(serve_path.wall_gates(s)) == {
        "paged_speedup_vs_dense >= 1.5", "live_pause_itl_p95_ratio <= 3.0",
        "fused_int8_speedup_vs_baseline >= 1.5"}
    assert all(r["generated_tokens"] == r["requests"] * 6 for r in rows[:-1])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_kv_bytes_per_page_matches_jax(kv_dtype):
    """The bytes a page holds, from the port's ``init_paged_cache``: the
    JAX benchmark's count from its own pool."""
    trun = make_run_config("qwen3-0.6b", "decode_32k", smoke=True)
    got = serve_path.kv_bytes_per_page(build_model(trun), trun, max_len=64,
                                       wide=4, page_size=16,
                                       kv_dtype=kv_dtype, device="cpu")
    from repro.configs import make_run_config as jax_run_config
    jrun = jax_run_config("qwen3-0.6b", "decode_32k", smoke=True)
    shape = dataclasses.replace(jrun.shape, seq_len=64, global_batch=4)
    cache = jax_paged_cache(jax_model(jrun), shape, num_pages=2,
                            page_size=16, kv_dtype=kv_dtype)
    want = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        if path[-1].key in ("k", "v", "k_scale", "v_scale"):
            want += leaf.nbytes // 2
    assert got == want > 0


# ---------------------------------------------------------------------------
# throughput
# ---------------------------------------------------------------------------
def test_throughput_keys_match_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(ROOT / "benchmarks" /
                                              "throughput.py"),
                          "--steps", "2"], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = throughput.bench(2, device="cpu")
    assert list(got) == list(want)
    assert all(np.isfinite(v) for v in got.values())
    # the state and its int8 packing are the JAX benchmark's, byte for byte
    for key in ("snapshot_none_bytes", "snapshot_int8_bytes",
                "compression_ratio"):
        assert got[key] == want[key], key
    assert got["step_ms_before_pause"] > 0 < got["step_ms_after_unpause"]


def test_throughput_tenant_is_bit_equal_to_a_never_paused_twin(tmp_path):
    """The cycle's pause and unpause change nothing of the state: after
    it, the tenant's state equals a twin's that ran as many steps
    undisturbed (the check the card's phase holds at full width)."""
    import torch
    from repro_torch.tree import flatten
    _, tn = throughput.run_bench(2, device="cpu")
    tw = throughput.twin(tn, 2, str(tmp_path), local_batch=4, seq_len=64)
    a, b = flatten(tn.export_state())[0], flatten(tw.export_state())[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), p
