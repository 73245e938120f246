"""The port's mesh GPipe (``repro_torch.runtime.pipeline.pipeline_apply``)
over a 4-rank gloo world on the CPU: the tanh stage of
``tests/test_pipeline_parallel.py`` against the JAX package's
``pipeline_apply`` on a 4-device mesh (a subprocess) and bit for bit
against the port's own per-microbatch sequential composition; fewer
microbatches than stages, one-rank groups (S = 1), and stage params whose
leading dim is not the group's size.

The ranks are processes running this file as a script (see
``tests/test_torch_collectives.py``)."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_collectives import launch_ranks

WORLD = 4
CASES = {"main": (4, 8, 2, 16), "few": (4, 2, 2, 16)}   # S, M, mb, D


def make_inputs(S, M, mb, D, seed):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((S, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, mb, D)).astype(np.float32)
    return W, b, x


def stage(params, h):
    w, bb = params
    return torch.tanh(h @ w + bb)


def sequential(W, b, x):
    """Each microbatch through the stages one after another, at the
    pipeline's (mb, D) shapes."""
    W, b, x = map(torch.from_numpy, (W, b, x))
    out = torch.empty_like(x)
    for m in range(x.shape[0]):
        h = x[m]
        for s in range(W.shape[0]):
            h = stage((W[s], b[s]), h)
        out[m] = h
    return out.numpy()


JAX_PROG = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.runtime.pipeline import pipeline_apply
workdir = sys.argv[1]
mesh = jax.make_mesh((4,), ("pipe",))

def stage(params, h):
    w, bb = params
    return jnp.tanh(h @ w + bb)

out = {}
for name in json.loads(sys.argv[2]):
    d = np.load(os.path.join(workdir, f"{name}.npz"))
    got = jax.jit(lambda p, xx: pipeline_apply(stage, p, xx, mesh))(
        (jnp.asarray(d["W"]), jnp.asarray(d["b"])), jnp.asarray(d["x"]))
    out[name] = np.asarray(got)
np.savez(os.path.join(workdir, "jax.npz"), **out)
"""


def rank_main(rank: int, world: int, workdir: str):
    import torch.distributed as dist
    from repro_torch.runtime.pipeline import pipeline_apply
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg",
                            rank=rank, world_size=world)
    try:
        out = {}
        for name in CASES:
            d = np.load(os.path.join(workdir, f"{name}.npz"))
            p = (torch.from_numpy(d["W"]), torch.from_numpy(d["b"]))
            out[name] = pipeline_apply(stage, p, torch.from_numpy(d["x"])
                                       ).numpy()
        # S = 1: every rank its own one-rank group (all ranks make each)
        solo = [dist.new_group([r]) for r in range(world)]
        d = np.load(os.path.join(workdir, "solo.npz"))
        p = (torch.from_numpy(d["W"]), torch.from_numpy(d["b"]))
        out["solo"] = pipeline_apply(stage, p, torch.from_numpy(d["x"]),
                                     group=solo[rank]).numpy()
        # stage params for 3 stages in a world of 4
        d = np.load(os.path.join(workdir, "main.npz"))
        try:
            pipeline_apply(stage, (torch.from_numpy(d["W"][:3]),
                                   torch.from_numpy(d["b"][:3])),
                           torch.from_numpy(d["x"]))
            raised = ""
        except ValueError as e:
            raised = str(e)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        with open(os.path.join(workdir, f"raised{rank}.json"), "w") as f:
            json.dump(raised, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("pipeline_apply")
    inputs = {}
    for seed, (name, dims) in enumerate(CASES.items()):
        inputs[name] = make_inputs(*dims, seed=seed)
    inputs["solo"] = make_inputs(1, 3, 2, 16, seed=9)
    for name, (W, b, x) in inputs.items():
        np.savez(workdir / f"{name}.npz", W=W, b=b, x=x)
    jax_cmd = [sys.executable, "-c", JAX_PROG, str(workdir),
               json.dumps(sorted(CASES))]
    launch_ranks(os.path.abspath(__file__), WORLD, workdir, extra=[jax_cmd])
    ranks = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(WORLD)]
    raised = [json.load(open(workdir / f"raised{r}.json"))
              for r in range(WORLD)]
    return inputs, ranks, dict(np.load(workdir / "jax.npz")), raised


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_and_the_sequential_composition(results, name):
    inputs, ranks, jx, _ = results
    want = sequential(*inputs[name])
    for r in ranks:
        assert np.array_equal(r[name], want), name
    assert float(np.abs(ranks[0][name] - jx[name]).max()) < 1e-5


def test_one_rank_groups_run_the_single_stage(results):
    inputs, ranks, _, _ = results
    want = sequential(*inputs["solo"])
    for r in ranks:
        assert np.array_equal(r["solo"], want)


def test_stage_count_other_than_the_world_raises(results):
    *_, raised = results
    assert all("leading dim must be the group's 4 stages" in e
               for e in raised), raised


def test_no_process_group_raises():
    import torch.distributed as dist
    from repro_torch.runtime.pipeline import pipeline_apply
    assert not dist.is_initialized()
    W, b, x = make_inputs(1, 2, 2, 4, seed=0)
    with pytest.raises(RuntimeError, match="process group"):
        pipeline_apply(stage, (torch.from_numpy(W), torch.from_numpy(b)),
                       torch.from_numpy(x))


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
