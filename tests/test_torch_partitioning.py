"""The port's sharding rules and mesh helpers (``repro_torch.runtime.
partitioning``, ``repro_torch.launch.mesh``) against the JAX package's:
parameter specs of every registered arch on both production meshes,
every activation kind on a grid of shapes with SP on and off,
``attn_mode``, the train-state and batch specs of each optimizer, the
rule cases of ``tests/test_runtime.py``, DTensor placements, and the
mesh helpers without a world or on a one-rank gloo world."""
import copy
import itertools
import pickle
import threading

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import MULTI_POD_MESH as J_MULTI
from repro.configs import SINGLE_POD_MESH as J_SINGLE
from repro.configs import MeshConfig as JMesh
from repro.configs import ShardingConfig as JSharding
from repro.configs import list_archs as jax_archs
from repro.configs import make_run_config as jax_run_config
from repro.core.snapshot import serialize_specs as jax_serialize
from repro.models.model import build_model as jax_model
from repro.runtime.partitioning import ShardingRules as JRules
from repro.train.step import batch_specs as jax_batch_specs
from repro.train.step import train_state_specs as jax_state_specs
from repro_torch.configs import (MULTI_POD_MESH, SINGLE_POD_MESH, UNIT_MESH,
                                 MeshConfig, ShardingConfig, list_archs,
                                 make_run_config)
from repro_torch.core.snapshot import serialize_specs
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import build_model
from repro_torch.runtime.partitioning import (P, ShardingRules, constrain,
                                              current_rules, placements,
                                              sharding_scope)
from repro_torch.train.step import batch_specs, train_state_specs

ARCHS = jax_archs()
MESHES = {"single": (SINGLE_POD_MESH, J_SINGLE),
          "multi": (MULTI_POD_MESH, J_MULTI)}


def _rules(arch, shape="train_4k", mesh="single", sp=False, **kw):
    tm, jm = MESHES[mesh]
    trun = make_run_config(arch, shape, mesh=tm,
                           sharding=ShardingConfig(seq_shard_acts=sp), **kw)
    jrun = jax_run_config(arch, shape, mesh=jm,
                          sharding=JSharding(seq_shard_acts=sp), **kw)
    return trun, ShardingRules(tm, trun), jrun, JRules(jm, jrun)


def _flat_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _flat_port(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}[{k!r}]"))
        else:
            out[f"{prefix}[{k!r}]"] = tuple(v)
    return out


def test_port_registers_every_jax_arch():
    assert set(ARCHS) <= set(list_archs())


# ---------------------------------------------------------------------------
# parameters, train state, batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, mesh, shape):
    trun, trules, jrun, jrules = _rules(arch, shape, mesh)
    want = _flat_jax(jrules.param_specs(jax_model(jrun).param_shapes()))
    got = _flat_port(trules.param_specs(build_model(trun).param_shapes()))
    assert got == want
    assert all(isinstance(s, tuple) for s in got.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_and_attn_mode_equal_jax(arch, mesh):
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        trun, trules, jrun, jrules = _rules(arch, shape, mesh)
        got = {k: tuple(v) for k, v in batch_specs(trun, trules).items()}
        want = {k: tuple(v)
                for k, v in jax_batch_specs(jrun, jrules).items()}
        assert got == want, shape
    heads = trun.model.num_heads
    for n in (None, heads, 7, 48):
        assert trules.attn_mode(n) == jrules.attn_mode(n), n


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_train_state_specs_equal_jax(opt, mesh):
    """Every arch's train-state spec tree, serialized as a pause snapshot
    serializes it: the same entries in the same order."""
    for arch in ARCHS:
        trun, trules, jrun, jrules = _rules(arch, mesh=mesh, optimizer=opt)
        got = serialize_specs(train_state_specs(trun, trules))
        want = jax_serialize(jax_state_specs(jrun, jrules))
        assert [tuple(e) for e in got] == [tuple(e) for e in want], arch


@pytest.mark.parametrize("shape", [(2, 1), (4, 2), (2, 2), (8, 1)])
def test_train_state_specs_on_vf_meshes_equal_jax(shape):
    """The small meshes a VF of an 8-slot pool has, at smoke size."""
    axes = ("data", "model")
    trun = make_run_config("qwen3-0.6b", "train_4k", smoke=True)
    jrun = jax_run_config("qwen3-0.6b", "train_4k", smoke=True)
    got = serialize_specs(train_state_specs(
        trun, ShardingRules(MeshConfig(shape, axes), trun)))
    want = jax_serialize(jax_state_specs(
        jrun, JRules(JMesh(shape, axes), jrun)))
    assert [tuple(e) for e in got] == [tuple(e) for e in want]


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
KINDS = {"batch": 2, "hidden": 3, "hidden_full": 3, "logits": (2, 3),
         "attn_q": 4, "attn_kv": 4, "kv_cache": 4, "state": (2, 4),
         "expert": 4, "moe_mask": 3, "moe_counts": 2, "moe_dispatch": 4,
         "no_such_kind": 2}
DIMS = (1, 2, 8, 16, 48, 256)


def _spec_or_key_error(rules, kind, shape):
    try:
        return tuple(rules.spec(kind, shape))
    except KeyError as e:
        return ("KeyError", str(e))


@pytest.mark.parametrize("sp", [False, True], ids=["plain", "sp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["llama3-8b", "phi3-mini-3.8b",
                                  "jamba-1.5-large-398b"])
def test_activation_specs_equal_jax(arch, mesh, sp):
    for shape_name in ("train_4k", "long_500k"):
        _, trules, _, jrules = _rules(arch, shape_name, mesh, sp=sp)
        for kind, ranks in KINDS.items():
            for rank in (ranks if isinstance(ranks, tuple) else (ranks,)):
                for shape in itertools.product(DIMS, repeat=rank):
                    got = _spec_or_key_error(trules, kind, shape)
                    want = _spec_or_key_error(jrules, kind, shape)
                    assert got == want, (kind, shape)


# ---------------------------------------------------------------------------
# the rule cases of tests/test_runtime.py
# ---------------------------------------------------------------------------
def _case_param_specs_cover_all_archs():
    for arch in ARCHS:
        run = make_run_config(arch, "train_4k", mesh=SINGLE_POD_MESH)
        rules = ShardingRules(SINGLE_POD_MESH, run)
        shapes = build_model(run).param_shapes()
        specs = rules.param_specs(shapes)

        def check(sd, spec):
            if isinstance(sd, dict):
                for k in sd:
                    check(sd[k], spec[k])
                return
            ent = tuple(spec) + (None,) * (len(sd.shape) - len(spec))
            for dim, ax in zip(sd.shape, ent):
                assert ax is None or dim % rules._size(ax) == 0, \
                    (arch, sd.shape, spec)
        check(shapes, specs)


def _case_attn_mode_selection():
    r_phi = ShardingRules(SINGLE_POD_MESH, make_run_config(
        "phi3-mini-3.8b", "train_4k", mesh=SINGLE_POD_MESH))
    assert r_phi.attn_mode(32) == "heads"
    r_llama = ShardingRules(SINGLE_POD_MESH, make_run_config(
        "llama3-8b", "train_4k", mesh=SINGLE_POD_MESH))
    assert r_llama.attn_mode(32) == "seq"
    r_unit = ShardingRules(UNIT_MESH, make_run_config("llama3-8b",
                                                      "train_4k"))
    assert r_unit.attn_mode(32) == "heads"


def _case_kv_cache_spec_long_context_batch1():
    run = make_run_config("jamba-1.5-large-398b", "long_500k",
                          mesh=SINGLE_POD_MESH)
    spec = ShardingRules(SINGLE_POD_MESH, run).spec(
        "kv_cache", (1, 524288, 8, 128))
    assert spec[0] is None and spec[1] is not None


def _case_moe_expert_spec():
    run = make_run_config("arctic-480b", "train_4k", mesh=SINGLE_POD_MESH)
    spec = ShardingRules(SINGLE_POD_MESH, run).spec(
        "expert", (128, 2048, 10, 7168))
    assert spec[0] == "model" and spec[1] == "data"


def _case_multipod_fsdp_axes():
    run = make_run_config("llama3-8b", "train_4k", mesh=MULTI_POD_MESH)
    rules = ShardingRules(MULTI_POD_MESH, run)
    assert rules.dp_axes == ("pod", "data")
    spec = rules.param_spec("params/decoder/layers/block0/ffn/wi",
                            (32, 4096, 14336))
    assert spec[0] is None
    assert spec[1] == ("pod", "data")
    assert spec[2] == "model"


def _case_lm_head_sp_mode():
    run = make_run_config("llama3-8b", "train_4k", mesh=SINGLE_POD_MESH,
                          sharding=ShardingConfig(seq_shard_acts=True))
    spec = ShardingRules(SINGLE_POD_MESH, run).param_spec(
        "params/lm_head", (4096, 128256))
    assert spec[1] is None


RUNTIME_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_param_specs_cover_all_archs, _case_attn_mode_selection,
    _case_kv_cache_spec_long_context_batch1, _case_moe_expert_spec,
    _case_multipod_fsdp_axes, _case_lm_head_sp_mode)}


@pytest.mark.parametrize("case", sorted(RUNTIME_CASES))
def test_runtime_rule_cases(case):
    RUNTIME_CASES[case]()


# ---------------------------------------------------------------------------
# P, placements, scope, constrain, meshes
# ---------------------------------------------------------------------------
def test_spec_is_a_tuple_that_survives_pickle_and_copy():
    p = P(None, ("pod", "data"), "model")
    assert tuple(p) == tuple(JP(None, ("pod", "data"), "model"))
    assert P() == () and len(P(None)) == 1
    for q in (pickle.loads(pickle.dumps(p)), copy.deepcopy(p), copy.copy(p)):
        assert type(q) is P and q == p


def test_placements_on_small_and_production_axes():
    from torch.distributed.tensor import Replicate, Shard
    assert placements(P("data", None), ("data", "model")) == \
        (Shard(0), Replicate())
    assert placements(P(None, "model"), ("data", "model")) == \
        (Replicate(), Shard(1))
    assert placements(P(), ("data", "model")) == (Replicate(), Replicate())
    axes = ("pod", "data", "model")
    assert placements(P(None, ("pod", "data"), "model"), axes) == \
        (Shard(1), Shard(1), Shard(2))
    assert placements(P("model", None), axes) == \
        (Replicate(), Replicate(), Shard(0))
    # a full qwen3-0.6b train state: every placement names a real dim
    run = make_run_config("qwen3-0.6b", "train_4k", mesh=MULTI_POD_MESH)
    specs = train_state_specs(run, ShardingRules(MULTI_POD_MESH, run))
    for path, entry in serialize_specs(specs):
        pl = placements(P(*[tuple(e) if isinstance(e, list) else e
                            for e in entry]), axes)
        assert len(pl) == 3
        assert all(isinstance(x, Replicate) or x.dim < len(entry)
                   for x in pl), path


def test_sharding_scope_is_thread_local_and_constrain_follows_jax():
    """The identity with no scope, on the unit mesh and with the mesh-less
    (``mesh=None``) rules of a 256-device mesh, as the dry-run's meta
    trace holds them; with a real (2, 2) CPU mesh in scope a DTensor
    takes the placements of ``rules.spec``."""
    import spmd_cases
    from repro_torch.core.ranks import RankPool
    x = torch.ones(4, 8, 16)
    assert current_rules() is None and constrain(x, "hidden") is x
    unit = ShardingRules(UNIT_MESH, make_run_config("llama3-8b",
                                                    "train_4k"))
    big = ShardingRules(SINGLE_POD_MESH, make_run_config(
        "llama3-8b", "train_4k", mesh=SINGLE_POD_MESH))
    seen = []
    with sharding_scope(unit):
        assert current_rules() is unit and constrain(x, "hidden") is x
        t = threading.Thread(target=lambda: seen.append(current_rules()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with sharding_scope(big):
            y = torch.ones(256, 8, 64)
            assert big.mesh is None and constrain(x, "hidden") is x
            assert constrain(y, "logits") is y
        assert current_rules() is unit
    assert seen == [None] and current_rules() is None
    run = make_run_config("qwen3-0.6b", "train_4k", smoke=True)
    with RankPool(4, device="cpu") as rp:
        mesh = rp.mesh((2, 2), ("data", "model"), rp.ranks)
        bad = rp.run_on(rp.ranks, spmd_cases.constrain_layouts, mesh.key,
                        run, {"hidden": 3, "logits": 3, "attn_q": 4})
    assert bad == [[]] * 4


def test_mesh_configs_and_no_world():
    assert tmesh.mesh_config() == SINGLE_POD_MESH
    assert tmesh.mesh_config(multi_pod=True) == MULTI_POD_MESH
    assert tmesh.local_mesh_config("cpu") == UNIT_MESH
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.local_mesh_config()
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="mesh=None"):
        ShardingRules(UNIT_MESH, make_run_config("qwen3-0.6b",
                                                 "train_4k")).named({})


def test_one_rank_world_mesh_and_tenant_state_shardings(tmp_path):
    """A (1, 1) DeviceMesh over a one-rank gloo world: the train tenant's
    state shardings are all replicated there; a production mesh asks for
    256 ranks and raises."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from repro_torch.core import Tenant
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = tmesh.make_mesh_from_config(UNIT_MESH, "cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="256 ranks"):
            tmesh.make_production_mesh(device_type="cpu")
        run = make_run_config("qwen3-0.6b", "train_4k", smoke=True)
        tn = Tenant("vm0", run, device="cpu")
        sh = tn.state_shardings(mesh)
        flat = _flat_port({"s": sh})
        assert flat and all(v == (Replicate(), Replicate())
                            for v in flat.values())
    finally:
        dist.destroy_process_group()
