"""The port stands on its own: nothing under ``src/repro_torch/`` and
nothing in ``chip_smoke.py`` or the tools beside it imports JAX or the JAX package, its entry
points default to the card, and ``chip_smoke.py`` refuses to run without
one."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "hybrid_prefill_margin.py",
        ROOT / "tools" / "attn_same_call.py",
        ROOT / "tools" / "train_readings.py",
        ROOT / "tools" / "gloo_cuda_probe.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_sim_plane_and_benchmarks_are_checked():
    """The sim plane and the benchmarks of the scenario sweep, crash
    matrix and pause path are among the files held free of JAX above."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files()
               if PORT in p.parents}
    for mod in ("sim/__init__.py", "sim/clock.py", "sim/scenario.py",
                "sim/tenant.py", "sim/invariants.py", "sim/chaos.py",
                "sim/harness.py", "bench/scenario_sweep.py",
                "bench/crash_matrix.py", "bench/pause_path.py"):
        assert mod in checked, mod


def test_elastic_plane_modules_are_checked():
    """The autoscaler (a copy of the JAX package's standard-library-only
    module, not an import of it) and the migration and elastic-sweep
    drivers are among the files held free of JAX above."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files()
               if PORT in p.parents}
    for mod in ("core/autoscaler.py", "serve/fleet.py", "serve/engine.py",
                "bench/migration.py", "bench/elastic_sweep.py"):
        assert mod in checked, mod


def test_pipeline_modules_are_checked():
    """The pipeline-parallel serving modules (the GPipe schedule, the
    stage templates, the pipeline engine) and their driver are among the
    files held free of JAX above."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files()
               if PORT in p.parents}
    for mod in ("runtime/pipeline.py", "serve/stages.py",
                "serve/pipeline_engine.py", "bench/pipeline_serve.py"):
        assert mod in checked, mod


def test_serve_plane_benchmarks_and_runtime_are_checked():
    """``runtime`` (the kernel half of the roofline model) and the
    throughput, prefix-share, decode-roofline and serve-path benchmarks are
    among the files held free of JAX above."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files()
               if PORT in p.parents}
    for mod in ("runtime/__init__.py", "runtime/roofline.py",
                "bench/throughput.py", "bench/prefix_share.py",
                "bench/decode_roofline.py", "bench/serve_path.py"):
        assert mod in checked, mod


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where importing JAX
    or the JAX package fails."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.configs import make_run_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    run = make_run_config("qwen3-0.6b", "decode_32k", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(run).init()
    params = build_model(run).init(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(run, params, paged=True)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """No card: a non-zero exit and no result line — in the checkout and
    in a directory holding chip_smoke.py and nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_federation_modules_are_checked():
    """The federation's host, coordinator, scenario plane and benchmark are
    among the files held free of JAX above."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files()
               if PORT in p.parents}
    for mod in ("core/host.py", "core/federation.py", "sim/federation.py",
                "bench/federation.py"):
        assert mod in checked, mod


def test_federation_entry_points_default_to_cuda(tmp_path):
    """Every federation entry point that builds sim tenants places their
    state on the card unless told otherwise."""
    import inspect
    from repro_torch.sim import federation as fed
    for fn in (fed.build_fed_cell, fed.FedRunner, fed.run_fed_scenario,
               fed.run_network_fault_case, fed.network_fault_matrix):
        assert inspect.signature(fn).parameters["device"].default \
            == "cuda", fn.__name__
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.build_fed_cell(0, workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.run_network_fault_case("fed_submit_route", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        fed.run_fed_scenario(fed.FedScenarioConfig(seed=0, num_ops=5))


def test_distributed_runtime_and_examples_are_checked():
    """The distributed runtime (sharding rules, collectives, meshes) and the
    examples are among the files held free of JAX above."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files()
               if PORT in p.parents}
    for mod in ("runtime/partitioning.py", "runtime/collectives.py",
                "launch/mesh.py", "examples/__init__.py",
                "examples/quickstart.py", "examples/elastic_reconf.py",
                "examples/serve_batched.py", "examples/train_100m.py"):
        assert mod in checked, mod


def test_examples_and_meshes_default_to_cuda():
    """Every example runs on the card unless told otherwise, and so does
    the local mesh; without a card they raise before any work."""
    import inspect
    from repro_torch.examples import (elastic_reconf, quickstart,
                                      serve_batched, train_100m)
    from repro_torch.launch import mesh
    for mod in (quickstart, elastic_reconf, serve_batched, train_100m):
        assert mod.parser().parse_args([]).device == "cuda", mod.__name__
    assert inspect.signature(mesh.local_mesh_config).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for mod in (quickstart, elastic_reconf, serve_batched):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.local_mesh_config()


def test_dryrun_modules_are_checked():
    """The dry-run (its HLO parser copy, the roofline, the cost count and
    its two drivers) is among the files held free of JAX above."""
    checked = {p.relative_to(PORT).as_posix() for p in _port_files()
               if PORT in p.parents}
    for mod in ("runtime/hlo.py", "runtime/roofline.py", "launch/dryrun.py",
                "bench/roofline_table.py", "bench/run.py"):
        assert mod in checked, mod
