"""The port's examples (``repro_torch.examples``) on the CPU: each runs to
its end; ``serve_batched``'s token streams equal the JAX ``ServeEngine``'s
through the same traffic on the same weights; ``elastic_reconf``'s paused
layouts equal the JAX package's specs for the same meshes."""
import json
import os

import jax
import numpy as np

from repro.configs import MeshConfig as JMesh
from repro.configs import make_run_config as jax_run_config
from repro.core.snapshot import serialize_specs as jax_serialize
from repro.models.model import build_model as jax_model
from repro.runtime.partitioning import ShardingRules as JRules
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.train.step import train_state_specs as jax_state_specs
from repro_torch import interop
from repro_torch.configs import make_run_config
from repro_torch.examples import elastic_reconf, quickstart, serve_batched

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_quickstart_runs_on_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["steps_done"] == {"vm0": 6, "vm1": 6}
    text = capsys.readouterr().out
    assert "I/O while paused correctly refused" in text
    assert "all tenants live after reconf" in text


def test_elastic_reconf_layouts_equal_jax(capsys):
    """On a pool of 8 CPU ranks: the tenant's state resharded bit-equal
    onto (4, 2) and (2, 2), each rank holding the bytes the specs give
    it, and the paused layouts equal to JAX's specs for each mesh."""
    out = elastic_reconf.main(["--device", "cpu"])
    assert out["events"] == ["failure", "migrated"]
    assert out["steps_done"] == 6
    assert out["resharded"] == [(4, 2), (2, 2)]
    assert len(out["rank_bytes"]) == 4
    descs = out["sharding_desc"]
    assert sorted(descs) == [(2, 1), (2, 2), (4, 2)]
    jrun = jax_run_config("qwen3-0.6b", "train_4k", smoke=True)
    for shape, desc in descs.items():
        want = jax_serialize(jax_state_specs(jrun, JRules(
            JMesh(shape, ("data", "model")), jrun)))
        assert [tuple(e) for e in desc] == [tuple(e) for e in want], shape
    assert "[4] injected failure" in capsys.readouterr().out


def _jax_serve(run, params) -> list:
    """``examples/serve_batched.py``'s traffic on the JAX engine."""
    eng = JEngine(run, params, slots=4, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [JRequest(rid=i, prompt=rng.integers(0, run.model.vocab_size,
                                                int(rng.integers(4, 10))),
                     max_new_tokens=6)
            for i in range(10)]
    for r in reqs[:6]:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    eng.pause()
    for r in reqs[6:]:
        eng.submit(r)
    eng.unpause()
    steps = 0
    while (eng.step() or eng.queue) and steps < 500:
        steps += 1
    return reqs


def test_serve_batched_streams_equal_jax():
    jrun = jax_run_config("qwen3-0.6b", "decode_32k", smoke=True)
    jparams = jax_model(jrun).init(jax.random.key(0))
    want = _jax_serve(jrun, jparams)
    run = make_run_config("qwen3-0.6b", "decode_32k", smoke=True)
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    got = serve_batched.serve(run, params, "cpu")
    assert [r.rid for r in got] == [r.rid for r in want]
    assert all(r.done for r in got)
    assert [list(r.out) for r in got] == [[int(t) for t in r.out]
                                          for r in want]
    assert sum(len(r.out) for r in got) == 60


def test_serve_batched_main_runs_on_cpu(capsys):
    reqs = serve_batched.main(["--device", "cpu"])
    assert len(reqs) == 10 and all(len(r.out) == 6 for r in reqs)
    assert "[done] 10/10 requests" in capsys.readouterr().out


def test_train_100m_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """The example's whole path at a narrow width of its config, so that
    the three steps' checkpoint stays small; the config itself (76.5 M
    params) equals the JAX example's. The registry is restored after."""
    import dataclasses
    import importlib.util

    import repro_torch.configs.base as B
    from repro_torch.examples import train_100m
    spec = importlib.util.spec_from_file_location(
        "jax_train_100m", os.path.join(SRC, "..", "examples", "train_100m.py"))
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    full = train_100m.qwen3_100m()
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_example.qwen3_100m())
    assert f"{full.param_count() / 1e6:.1f}" == "76.5"
    monkeypatch.setattr(B, "_REGISTRY", dict(B._REGISTRY))
    monkeypatch.setattr(B, "_SMOKE_REGISTRY", dict(B._SMOKE_REGISTRY))
    monkeypatch.setattr(train_100m, "qwen3_100m", lambda: dataclasses.replace(
        full, num_layers=2, d_model=64, num_heads=2, num_kv_heads=1,
        d_ff=128, vocab_size=512, head_dim=32))
    rc = train_100m.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                          "--seq", "32", "--workdir", str(tmp_path)])
    assert rc == 0
    assert "model: qwen3-100m" in capsys.readouterr().out
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines)
    assert (tmp_path / "ckpt").is_dir()
