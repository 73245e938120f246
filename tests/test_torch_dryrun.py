"""The port's dry-run (``repro_torch.launch.dryrun``, ``runtime/hlo.py``,
``Roofline``, ``bench.roofline_table``, ``bench.run``) against the JAX
package's, on the CPU.

The JAX cells run in one subprocess: qwen3-0.6b at its smoke widths on a
(4, 2) mesh of forced host devices, through JAX's own ``run_cell``. Under
jax 0.9, ``jax.make_mesh`` gives Explicit axes, which the JAX model's
``constrain`` refuses; the subprocess builds the mesh with Auto axes
instead (patching ``make_production_mesh`` and ``mesh_config``, as
``tests/test_system.py`` patches them), and nothing in ``src/repro``
changes. It also hands back each cell's compiled HLO text.

Tolerances, with the ratios measured here (port / JAX):
- per-device flops within 10% for ``train_4k`` (0.959) and
  ``prefill_32k`` (0.968), and for ``prefill_32k`` on a (2, 4) mesh
  (0.966), where kv heads 2 do not divide the model axis and attention
  splits its query rows ("seq" mode; the divisor is still all 8 devices);
- ``decode_32k`` within 25%, held at fp32 compute (0.985). At the default
  bf16 compute the ratio is 0.198: XLA:CPU rewrites each layer's cache
  row write as a convert of the whole bf16 cache stack to fp32 and back
  (the ``dynamic-update-slice`` fusions of the decode HLO, ~5x the
  attention's flops), which XLA counts and the port, writing one row in
  place, does not issue;
- argument bytes equal, leaf for leaf under the same specs;
- collective bytes within 2x (train 0.74, prefill 0.87), with the same
  set of ops once the model's gradient reduce-scatter is read as the
  all-reduce that XLA:CPU emits for it. Held in "heads" mode only: the
  ring model has no term for the "seq" mode's re-layouts of q, k and v
  (XLA's all-gathers, all-to-alls and collective-permutes), and counts
  0.19x of JAX's bytes on the (2, 4) prefill cell.
"""
import dataclasses
import importlib
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.runtime import hlo as jhlo
from repro.runtime import roofline as jroof
from repro_torch.configs.base import (SHAPES, MeshConfig, PrecisionConfig,
                                      ShardingConfig, UNIT_MESH)
from repro_torch.launch import dryrun as D
from repro_torch.runtime import hlo as thlo
from repro_torch.runtime import roofline as troof

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = MeshConfig((4, 2), ("data", "model"))
CELLS = ("train_4k", "prefill_32k", "decode_32k")
F32 = "decode_32k-f32"           # the decode cell at fp32 compute
# the prefill cell on (2, 4): kv heads 2 do not divide the model axis 4,
# so attention splits its query rows over it ("seq" mode)
SEQ = "prefill_32k-seq"
MESHES = {SEQ: MeshConfig((2, 4), ("data", "model"))}

JAX_PROG = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
import repro.configs.base as B
import repro.launch.dryrun as D
texts = []
real = D.collective_stats
D.collective_stats = lambda text: (texts.append(text), real(text))[1]
out = sys.argv[1]
for mesh, shape, tag, prec in (((4, 2), "train_4k", "", None),
                               ((4, 2), "prefill_32k", "", None),
                               ((4, 2), "decode_32k", "", None),
                               ((4, 2), "decode_32k", "f32", "float32"),
                               ((2, 4), "prefill_32k", "seq", None)):
    mc = B.MeshConfig(mesh, ("data", "model"))
    D.mesh_config = lambda *, multi_pod=False, mc=mc: mc
    D.make_production_mesh = lambda *, multi_pod=False, mesh=mesh: (
        jax.make_mesh(mesh, ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2))
    texts.clear()
    ov = {"smoke": True}
    if prec:
        ov["precision"] = B.PrecisionConfig(compute=prec)
    r = D.run_cell("qwen3-0.6b", shape, False, out_dir=out, force=True,
                   tag=tag, overrides=ov)
    assert r["status"] == "ok", r.get("error")
    name = shape + (f"-{tag}" if tag else "")
    with open(os.path.join(out, name + ".hlo"), "w") as f:
        f.write(texts[0])          # the cell's own compile, before true_costs
"""


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", JAX_PROG, str(out)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return out


def _jax_cell(jax_dir, name):
    shape, _, tag = name.partition("-")
    mesh = "single" + (f"-{tag}" if tag else "")
    return json.loads((jax_dir / f"qwen3-0.6b__{shape}__{mesh}.json")
                      .read_text())


@pytest.fixture(scope="module")
def port_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_dryrun")
    cells = {}
    for name in CELLS + (F32, SEQ):
        shape, _, tag = name.partition("-")
        ov = {"smoke": True}
        if tag == "f32":
            ov["precision"] = PrecisionConfig(compute="float32")
        cells[name] = D.run_cell("qwen3-0.6b", shape, False, out_dir=out,
                                 force=True, tag=tag, overrides=ov,
                                 mesh=MESHES.get(name, MESH))
        assert cells[name]["status"] == "ok", cells[name].get("traceback")
    return cells


def _ratio(port, jax, key):
    return port["cost_extrapolated"][key] / jax["cost_extrapolated"][key]


@pytest.mark.parametrize("name,tol", [("train_4k", 0.10),
                                      ("prefill_32k", 0.10), (F32, 0.25),
                                      (SEQ, 0.10)])
def test_per_device_flops_match_jax(jax_dir, port_cells, name, tol):
    r = _ratio(port_cells[name], _jax_cell(jax_dir, name), "flops")
    assert abs(r - 1) <= tol, r


def test_seq_mode_divides_by_every_device(port_cells):
    """In "seq" mode the model axis still splits the work (the weights by
    the %M rules, attention by query rows): the divisor is all 8 devices,
    and the per-device count equals the heads-mode cell's."""
    seq, heads = port_cells[SEQ], port_cells["prefill_32k"]
    assert seq["divisor"] == heads["divisor"] == 8
    assert _ratio(seq, heads, "flops") == pytest.approx(1.0, rel=1e-9)


def test_bf16_decode_gap_is_xla_cpus_cache_converts(jax_dir, port_cells):
    """At bf16 compute the port counts what the fp32 cell counts plus its
    own casts, while XLA:CPU adds the converts of the whole cache stack:
    the JAX count grows ~6x, the port's by under 30%."""
    port, jax = port_cells["decode_32k"], _jax_cell(jax_dir, "decode_32k")
    port32, jax32 = port_cells[F32], _jax_cell(jax_dir, F32)
    assert _ratio(port, port32, "flops") < 1.3
    assert _ratio(jax, jax32, "flops") > 5


@pytest.mark.parametrize("name", CELLS + (F32, SEQ))
def test_argument_bytes_equal_jax(jax_dir, port_cells, name):
    """The leaves of the train state and batch (train), params and tokens
    (prefill), params, cache, tokens and pos (decode), each over its
    shard count under the specs that tests/test_torch_partitioning.py
    holds equal to JAX's."""
    assert (port_cells[name]["memory"]["argument_bytes"]
            == _jax_cell(jax_dir, name)["memory"]["argument_bytes"])


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k"])
def test_collectives_within_2x_of_jax_with_the_same_ops(jax_dir, port_cells,
                                                        name):
    port = port_cells[name]["collectives"]
    jax = _jax_cell(jax_dir, name)["collectives"]
    assert 0.5 <= port["total_bytes"] / jax["total_bytes"] <= 2.0
    as_xla_cpu = {"reduce-scatter": "all-reduce"}
    assert ({as_xla_cpu.get(op, op) for op in port["bytes_by_op"]}
            == set(jax["bytes_by_op"]))


@pytest.mark.parametrize("name", CELLS)
def test_bytes_at_least_the_arguments_read_once(port_cells, name):
    cell = port_cells[name]
    assert (cell["cost_extrapolated"]["bytes"]
            >= cell["memory"]["argument_bytes"])


@pytest.mark.parametrize("name", CELLS + (F32, SEQ))
def test_hlo_parser_bit_equal_on_jax_hlo(jax_dir, name):
    text = (jax_dir / f"{name}.hlo").read_text()
    assert (thlo.collective_stats(text).describe()
            == jhlo.collective_stats(text).describe())
    assert thlo.scan_op_counts(text) == jhlo.scan_op_counts(text)
    assert thlo.collective_stats(text).total_count > 0


@pytest.mark.parametrize("a,b,c", [(1, 1, 1), (3, 64, 7), (64, 5, 64),
                                   (17, 33, 2)])
def test_hlo_parser_bit_equal_on_synthetic_lines(a, b, c):
    """The lines of ``tests/test_properties.py``'s parser property."""
    txt = (f"  %ag = bf16[{a},{b}] all-gather(x), dims={{0}}\n"
           f"  %ar = (f32[{c}], f32[{a},{b},{c}]) all-reduce(y, z)\n"
           f"  %nope = f32[{a}] add(u, v)\n")
    port, jax = thlo.collective_stats(txt), jhlo.collective_stats(txt)
    assert port.describe() == jax.describe()
    assert port.bytes_by_op["all-gather"] == a * b * 2
    assert port.bytes_by_op["all-reduce"] == 4 * c + 4 * a * b * c
    assert port.total_count == 2
    assert thlo.scan_op_counts(txt) == jhlo.scan_op_counts(txt)


ROOFLINE_CASES = [
    # tests/test_runtime.py::test_roofline_terms_and_bound
    dict(arch="x", shape="train_4k", mesh="single", chips=256,
         hlo_flops=197e12, hlo_bytes=819e9 * 2, collective_bytes=50e9,
         collective_detail={"bytes_by_op": {"all-reduce": 50e9}},
         model_flops=197e12 * 256),
    dict(arch="y", shape="decode_32k", mesh="multi", chips=512,
         hlo_flops=3e9, hlo_bytes=7e8, collective_bytes=2e6,
         collective_detail={"bytes_by_op": {"all-gather": 1e6,
                                            "all-to-all": 1e6}},
         model_flops=1e12),
    dict(arch="z", shape="prefill_32k", mesh="single", chips=256,
         hlo_flops=1e15, hlo_bytes=1e9, collective_bytes=4e9,
         model_flops=0.0),
]


@pytest.mark.parametrize("case", ROOFLINE_CASES)
@pytest.mark.parametrize("peaks", [(197e12, 819e9, 50e9),
                                   (989e12, 3.35e12, 900e9)])
def test_roofline_rows_equal_jax(case, peaks):
    port = troof.Roofline(**case, peaks=troof.Peaks(*peaks)).row()
    jax = jroof.Roofline(**case, peaks=jroof.Peaks(*peaks)).row()
    assert port == jax


def test_roofline_aliases_and_mesh_peaks():
    assert (troof.PEAK_FLOPS_BF16, troof.HBM_BW, troof.ICI_BW) == (
        989e12, 3.35e12, 900e9)
    assert troof._AR_FACTOR == jroof._AR_FACTOR
    assert troof.mesh_peaks(1) == troof.mesh_peaks(8) == troof.Peaks()
    assert troof.mesh_peaks(256).ici_bw == troof.INTER_NODE_BW == 50e9
    assert troof.mesh_peaks(512).flops == troof.Peaks().flops


def _jax_bench(monkeypatch, name):
    monkeypatch.syspath_prepend(str(ROOT))
    return importlib.import_module(f"benchmarks.{name}")


@pytest.mark.parametrize("which", ["jax", "port"])
def test_load_rows_and_markdown_equal_jax(jax_dir, port_cells, monkeypatch,
                                          tmp_path, which):
    from repro_torch.bench import roofline_table as port_table
    jax_table = _jax_bench(monkeypatch, "roofline_table")
    if which == "jax":
        d = jax_dir
    else:                                   # the port's cells as "single"
        d = tmp_path
        for name, cell in port_cells.items():
            tag = name.partition("-")[2]
            cell = dict(cell, mesh="single" + (f"-{tag}" if tag else ""))
            (d / f"{name}.json").write_text(json.dumps(cell))
        (d / "skip.json").write_text(json.dumps(
            {"arch": "a", "shape": "long_500k", "mesh": "multi",
             "status": "skipped", "reason": "r"}))
    rows = port_table.load_rows(str(d))
    assert rows == jax_table.load_rows(str(d))
    assert len(rows) >= 3
    assert port_table.markdown(rows) == jax_table.markdown(rows)


ROWS = {
    "table1": [{"num_vf": n, "detach_attach_ms": 1.5 * n,
                "detach_attach_std": 0.25, "pause_unpause_ms": 0.5 * n,
                "overhead_pct": 3.125} for n in (1, 4, 10)],
    "table2": [dict({f"{m}_{s}_ms": 0.1 * i + j
                     for i, m in enumerate(("DA", "PU"))
                     for j, s in enumerate(("rescan", "remove_vf",
                                            "change_num_vf", "add_vf"))},
                    num_vf=n, DA_total_ms=10.0 * n, PU_total_ms=2.0 * n)
               for n in (1, 4)],
    "throughput": [{"step_ms_before_pause": 1.25,
                    "pause_cycle_overhead_pct": -0.5,
                    "step_ms_after_unpause": 1.5, "snapshot_none_ms": 2.0,
                    "snapshot_none_bytes": 1234, "snapshot_int8_ms": 1.0,
                    "compression_ratio": 3.9}],
}


def test_bench_run_csv_rows_equal_jax(jax_dir, monkeypatch, tmp_path):
    from repro_torch.bench import run as port_run
    jax_run = _jax_bench(monkeypatch, "run")
    calls = []

    def fake_sub(mod, *args):
        calls.append((mod, args))
        return ROWS[mod.rsplit(".", 1)[1]]
    for m in (port_run, jax_run):
        monkeypatch.setattr(m, "_sub", fake_sub)
        monkeypatch.setattr(m, "OUT", str(tmp_path / m.__name__))
    assert port_run.table1(7) == jax_run.table1(7)
    assert port_run.table2() == jax_run.table2()
    assert port_run.throughput() == jax_run.throughput()
    # the port's drivers, on the card unless the caller asks otherwise
    port_mods = [c for c in calls if c[0].startswith("repro_torch.")]
    assert [c[0] for c in port_mods] == [
        "repro_torch.bench.table1", "repro_torch.bench.table2",
        "repro_torch.bench.throughput"]
    assert all(a[a.index("--device") + 1] == "cuda" for _, a in port_mods)
    # the roofline rows of the same cell directory
    jax_table = importlib.import_module("benchmarks.roofline_table")
    rows = jax_table.load_rows(str(jax_dir))
    from repro_torch.bench import roofline_table as port_table
    for table in (jax_table, port_table):
        monkeypatch.setattr(table, "load_rows", lambda: rows)
    assert port_run.roofline() == jax_run.roofline()


def test_true_costs_equal_one_full_trace():
    """qwen3-0.6b smoke deepened to 4 layers (its 2 layers would make the
    P=2 variant the full trace): the extrapolation from 1 and 2 periods
    equals one trace of the whole stack to fp64 rounding."""
    ov = {"smoke": True, "sharding": ShardingConfig(remat="full")}
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8,
                                seq_len=256)
    low, run, _ = D.lower_cell("qwen3-0.6b", "train_4k", False, ov,
                               shape=shape, mesh=MESH)
    deep = dataclasses.replace(run.model, num_layers=4)
    low, run, _ = D.lower_cell("qwen3-0.6b", "train_4k", False, ov,
                               model_override=deep, shape=shape, mesh=MESH)
    full = D._cost_of(low)
    tc = D.true_costs("qwen3-0.6b", "train_4k", False, run, ov)
    for key in D._LINEAR:
        assert tc[key] == pytest.approx(full[key], rel=1e-12), key
    assert tc["coll_by_op"] == pytest.approx(full["coll_by_op"], rel=1e-12)


@pytest.mark.parametrize("name", CELLS)
def test_the_count_allocates_nothing(name):
    """Every tensor an op makes or reads in a cell's trace is on ``meta``
    (the rope table, a host constant, is put there once and not counted)."""
    ov = {"smoke": True, "sharding": ShardingConfig(remat="full")}
    low, _, _ = D.lower_cell("qwen3-0.6b", name, False, ov, mesh=MESH)
    mode = D.CostMode()
    with mode:
        low.call()
    assert mode.devices == {"meta"}
    assert mode.ops > 0 and mode.host_constants <= 4 * 16


def test_inner_scan_correction_equals_jax():
    from repro.configs import get_model_config as jget
    from repro.configs import SHAPES as JSHAPES
    from repro.launch.dryrun import _inner_scan_correction as jcorr
    from repro_torch.configs import get_model_config as tget
    for smoke in (False, True):
        for shape in SHAPES:
            kind = SHAPES[shape].kind
            assert (D._inner_scan_correction(tget("xlstm-350m", smoke),
                                             SHAPES[shape], kind)
                    == jcorr(jget("xlstm-350m", smoke), JSHAPES[shape], kind))


def test_xlstm_cell_counts_one_trip_and_the_correction(tmp_path):
    """The xLSTM loops trace their first trip (restored after), and the
    JAX formulas add the others, over the cell's own device count."""
    from repro_torch.models import xlstm
    loops = (xlstm.mlstm_chunked, xlstm.slstm_scan)
    r = D.run_cell("xlstm-350m", "train_4k", False, out_dir=tmp_path,
                   overrides={"smoke": True}, mesh=MESH)
    assert r["status"] == "ok", r.get("traceback")
    assert (xlstm.mlstm_chunked, xlstm.slstm_scan) == loops
    corr = r["cost_extrapolated"]["inner_scan_corr_flops"]
    assert corr > 0
    assert r["cost_extrapolated"]["flops"] > corr / MESH.num_devices


def test_kernel_path_counts_the_kernels_work():
    """With the kernel path (``kernel_backend="auto"``), flash_decode on
    meta reports its work: the cache rows up to pos, read once. The
    wrappers are the kernel layer's own again after the count."""
    from repro_torch.kernels import ops as kops
    wrappers = (kops.flash_attention, kops.flash_decode)
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=2,
                                seq_len=512)
    low, run, _ = D.lower_cell("qwen3-0.6b", "decode_32k", False,
                               {"smoke": True, "kernel_backend": "auto"},
                               shape=shape, mesh=UNIT_MESH)
    got = D._cost_of(low)
    cfg = run.model
    assert got["kernels"] == {"flash_decode": cfg.num_layers}
    cache = 2 * 2 * 512 * cfg.num_kv_heads * cfg.head_dim * 2
    assert got["bytes"] >= cfg.num_layers * cache
    assert (kops.flash_attention, kops.flash_decode) == wrappers


@pytest.mark.parametrize("name", ["prefill_32k", "decode_32k"])
def test_kernel_path_fails_where_the_card_would(name):
    """At fp32 compute the kernels take fp32, as on the card: the count of
    the kernel path succeeds, the same kernel calls as at bf16 compute,
    each element at 4 bytes (the kernels' bytes twice the bf16 cell's).
    An fp16 input still fails the kernels' contract as the launch would,
    and the kernel layer itself has no kernels for meta tensors."""
    from repro_torch.kernels import ops as kops
    shape = dataclasses.replace(SHAPES[name], global_batch=2, seq_len=512)
    got = {}
    for compute in ("bfloat16", "float32"):
        ov = {"smoke": True, "kernel_backend": "auto",
              "precision": PrecisionConfig(compute=compute)}
        low, _, _ = D.lower_cell("qwen3-0.6b", name, False, ov, shape=shape,
                                 mesh=UNIT_MESH)
        got[compute] = D._cost_of(low)
    bf, fp = got["bfloat16"], got["float32"]
    assert fp["kernels"] == bf["kernels"] and sum(fp["kernels"].values())
    assert fp["kernel_bytes"] == {k: 2 * v
                                  for k, v in bf["kernel_bytes"].items()}
    kernel = "flash_attention" if name == "prefill_32k" else "flash_decode"
    q = torch.empty((1, 1, 4, 8), dtype=torch.float16, device="meta")
    k = torch.empty((1, 256, 2, 8), dtype=torch.float16, device="meta")
    pos = () if name == "prefill_32k" else (3,)
    with D._kernel_path(D.CostMode()):
        with pytest.raises(TypeError, match="torch.bfloat16 or torch.float32"):
            getattr(kops, kernel)(q, k, k, *pos)
    q, k = q.bfloat16(), k.bfloat16()
    with pytest.raises(ValueError, match="no kernels for device meta"):
        getattr(kops, kernel)(q, k, k, *pos)


def test_allocations_count_as_live_memory():
    """An allocation op (``empty``, ``empty_like``, a hand kernel's output)
    holds memory until its tensor dies, and moves no bytes."""
    mode = D.CostMode()
    with mode:
        a = torch.empty((1024,), device="meta")
        b = torch.empty_like(a)
        del a, b
        c = torch.empty((256,), device="meta")
    assert (mode.peak, mode.live, mode.bytes, mode.flops) == (8192, 1024, 0,
                                                              0)
    del c


def test_cli_writes_the_qwen_cells(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "qwen3-0.6b", "--mesh", "both", "--out",
                        str(tmp_path)], capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    cells = [json.loads(f.read_text()) for f in tmp_path.glob("*.json")]
    status = sorted((c["status"], c["shape"]) for c in cells)
    assert [s for s, _ in status].count("ok") == 6
    assert [c for s, c in status if s == "skipped"] == ["long_500k"] * 2
    for c in cells:
        if c["status"] == "ok":
            assert c["roofline"]["peak_ici_bw"] == 50e9     # > 8 cards
            assert c["chips"] in (256, 512)
            assert math.isfinite(c["roofline"]["step_s"])
