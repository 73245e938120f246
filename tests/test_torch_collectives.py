"""The port's int8-compressed gradient all-reduce
(``repro_torch.runtime.collectives``) over an 8-rank gloo world on the
CPU, against the exact mean and against the JAX package's
``compressed_grad_allreduce`` on an 8-device mesh (a subprocess, as
``tests/test_collectives.py`` runs it), on the inputs of both JAX tests
and on inputs whose sums are exact in any order.

The ranks are processes running this file as a script; they meet through
a file under the test's temporary directory (no port), load the inputs
from an ``.npz`` the test wrote, and save their results beside it."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
WORLD = 8
BLOCK = 256
BOUND = 0.5 / 127 * 1.15        # tests/test_collectives.py:87-89


def launch_ranks(script, world, workdir, timeout=300, extra=None):
    """Run ``script rank world workdir`` in ``world`` processes (and the
    ``extra`` commands beside them); every one must exit 0."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    procs += [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for cmd in (extra or [])]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode, log[-3000:])
           for i, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad


# ---------------------------------------------------------------------------
# inputs: each case a tree of (8, ...) per-replica leaves, made with numpy
# ---------------------------------------------------------------------------
def make_cases() -> dict:
    cases = {}
    rng = np.random.default_rng(0)          # tests/test_collectives.py:26
    cases["mixed"] = {
        "big": (rng.standard_normal((8, 16, 512)) * 3.0).astype(np.float32),
        "scaled": (rng.standard_normal((8, 4, 1024)) * 1e-4
                   ).astype(np.float32),
        "tiny": rng.standard_normal((8, 7)).astype(np.float32)}
    rng = np.random.default_rng(7)          # tests/test_collectives.py:69
    for name, scale in (("unit", 1.0), ("small", 1e-5), ("large", 1e4)):
        cases[name] = {"x": (rng.standard_normal((8, 16, 512)) * scale
                             ).astype(np.float32)}
    # sums exact in any order: small integers times a power of two; a
    # leaf that needs padding (4,000 values: rows of 512 for 500), a bf16
    # leaf, an exact-path leaf
    rng = np.random.default_rng(3)
    cases["exact"] = {
        "pad": (rng.integers(-64, 64, (8, 4, 1000)) * 2.0 ** -6
                ).astype(np.float32),
        "bf16": (rng.integers(-64, 64, (8, 8, 256)) * 2.0 ** -4
                 ).astype(np.float32),
        "small": (rng.integers(-64, 64, (8, 3, 5)) * 2.0 ** -3
                  ).astype(np.float32)}
    return cases


BF16_LEAVES = {("exact", "bf16")}


def _flat(cases):
    return {f"{c}/{k}": v for c, tree in cases.items()
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the JAX side (8 host devices) and the port's ranks
# ---------------------------------------------------------------------------
JAX_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, ml_dtypes
import numpy as np
from repro.runtime.collectives import compressed_grad_allreduce
workdir = sys.argv[1]
inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
bf16 = set(sys.argv[2].split(","))
mesh = jax.make_mesh((8,), ("data",))
cases = {}
for key, v in inp.items():
    c, k = key.split("/")
    x = jnp.asarray(v, jnp.bfloat16 if key in bf16 else jnp.float32)
    cases.setdefault(c, {})[k] = x
out = {}
for c, tree in cases.items():
    got = jax.jit(lambda g: compressed_grad_allreduce(g, mesh))(tree)
    for k, v in got.items():
        out[f"{c}/{k}"] = np.asarray(v.astype(jnp.float32))
np.savez(os.path.join(workdir, "jax.npz"), **out)
"""


def rank_main(rank: int, world: int, workdir: str):
    import torch.distributed as dist
    from repro_torch.runtime.collectives import (WireStats,
                                                 compressed_grad_allreduce)
    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg",
                            rank=rank, world_size=world)
    try:
        cases = {}
        for key, v in inp.items():
            c, k = key.split("/")
            x = torch.from_numpy(v[rank].copy())
            if tuple(key.split("/")) in BF16_LEAVES:
                x = x.to(torch.bfloat16)
            cases.setdefault(c, {})[k] = x
        out, stats = {}, {}
        for c, tree in cases.items():
            st = WireStats()
            got = compressed_grad_allreduce(tree, block=BLOCK, stats=st)
            for k, v in got.items():
                assert v.dtype == tree[k].dtype and v.shape == tree[k].shape
                out[f"{c}/{k}"] = v.to(torch.float32).numpy()
            stats[c] = dict(st.__dict__)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
        with open(os.path.join(workdir, f"stats{rank}.json"), "w") as f:
            json.dump(stats, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("collectives")
    cases = make_cases()
    np.savez(workdir / "inputs.npz", **_flat(cases))
    jax_cmd = [sys.executable, "-c", JAX_PROG, str(workdir),
               ",".join("/".join(k) for k in BF16_LEAVES)]
    launch_ranks(os.path.abspath(__file__), WORLD, workdir, extra=[jax_cmd])
    ranks = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(WORLD)]
    stats = [json.load(open(workdir / f"stats{r}.json"))
             for r in range(WORLD)]
    return cases, ranks, dict(np.load(workdir / "jax.npz")), stats


def _exact_mean(v, key):
    x = v.astype(np.float64)
    if tuple(key.split("/")) in BF16_LEAVES:
        x = torch.from_numpy(v).to(torch.bfloat16).double().numpy()
    return x.mean(0)


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def test_every_rank_gets_the_same_bits(results):
    _, ranks, _, _ = results
    for r in ranks[1:]:
        for key in ranks[0]:
            assert np.array_equal(r[key], ranks[0][key]), key


def test_error_bounds_of_the_jax_tests(results):
    """tests/test_collectives.py's bounds: the exact path within 1e-6,
    every compressed leaf within half an int8 step of its block max
    (0.5/127 x 1.15), which also holds the first test's 0.02."""
    cases, ranks, _, _ = results
    flat = _flat(cases)
    for key, v in flat.items():
        rel = _rel(ranks[0][key].astype(np.float64), _exact_mean(v, key))
        if v[0].size < 4 * BLOCK:
            assert rel < 1e-6, (key, rel)
        else:
            assert rel < BOUND, (key, rel)


def test_bit_equal_to_jax_where_sums_are_exact(results):
    _, ranks, jx, _ = results
    for key in ("exact/pad", "exact/bf16", "exact/small"):
        assert np.array_equal(ranks[0][key], jx[key]), key


def test_within_one_int8_step_of_jax_elsewhere(results):
    """The reduce-scatter sums in another order than XLA's, so a mean can
    differ in its last bits and round to the neighbouring int8 value: at
    most one step, the block's scale, apart."""
    cases, ranks, jx, _ = results
    for key, v in _flat(cases).items():
        got, want = ranks[0][key].reshape(-1), jx[key].reshape(-1)
        if v[0].size < 4 * BLOCK:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            continue
        exact = _exact_mean(v, key).reshape(-1)
        per = -(-exact.size // WORLD)
        per = -(-per // BLOCK) * BLOCK
        padded = np.zeros(WORLD * per)
        padded[:exact.size] = np.abs(exact)
        step = padded.reshape(-1, BLOCK).max(1) / 127
        step = np.repeat(step, BLOCK)[:exact.size]
        assert np.all(np.abs(got - want) <= step * (1 + 1e-3)), key


def test_wire_bytes_follow_the_ring_model(results):
    cases, _, _, stats = results
    assert all(s == stats[0] for s in stats)
    st = stats[0]
    assert st["mixed"]["compressed_leaves"] == 2
    assert st["mixed"]["exact_leaves"] == 1
    for c in ("unit", "small", "large"):
        n, numel, per = WORLD, 16 * 512, 16 * 512 // WORLD
        f = (n - 1) / n
        want = f * n * per * 4 + (n - 1) * (per + per // BLOCK * 4)
        assert st[c]["wire_bytes"] == pytest.approx(want)
        assert st[c]["plain_fp32_bytes"] == pytest.approx(2 * f * numel * 4)
        assert 0.6 < st[c]["wire_bytes"] / st[c]["plain_fp32_bytes"] < 0.64


def test_no_process_group_raises():
    import torch.distributed as dist
    from repro_torch.runtime.collectives import (compressed_grad_allreduce,
                                                 compressed_psum_mean)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        compressed_grad_allreduce({"x": torch.ones(3)})
    with pytest.raises(RuntimeError, match="process group"):
        compressed_psum_mean(torch.ones(1024))


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
