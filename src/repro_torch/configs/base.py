"""Configuration system for the PyTorch port (a copy of ``repro.configs.base``).

The port keeps its own copy so it never imports the JAX package. Two
changes from the original: ``param_count`` folds the port's own
parameter tree, and ``RunConfig.kernel_backend`` defaults to ``"auto"``,
which lets the tensors' device pick the kernels (see
``repro_torch.kernels.ops``); ``"reference"`` forces the plain versions.

Everything is a frozen dataclass so configs hash/compare cleanly — the
executable cache ("bitstream cache" in SVFF terms) is keyed on them.

An *architecture* config (``ModelConfig``) describes the network. A *shape*
config (``ShapeConfig``) describes one input-shape cell from the assignment
(train_4k / prefill_32k / decode_32k / long_500k). A ``RunConfig`` glues one
of each to mesh/optimizer/precision choices and is what launchers consume.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

# ---------------------------------------------------------------------------
# Block kinds understood by the model builder. A layer stack is described by a
# repeating *pattern* of blocks (len(pattern) must divide num_layers), which
# lets heterogeneous stacks (jamba's 1:7 attn:mamba, xlstm's mLSTM/sLSTM mix)
# scan over pattern-periods instead of unrolling all layers.
# ---------------------------------------------------------------------------
ATTN = "attn"      # full transformer block: attention + FFN (dense or MoE)
MAMBA = "mamba"    # mamba(-2 style SSD) block
MLSTM = "mlstm"    # xLSTM matrix-memory block
SLSTM = "slstm"    # xLSTM scalar-memory block (sequential recurrence)

VALID_BLOCKS = (ATTN, MAMBA, MLSTM, SLSTM)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_token: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    # layers whose (global) index satisfies index % every == offset get MoE
    every: int = 1
    offset: int = 0
    # Arctic-style: dense FFN in parallel (residual) with the MoE FFN
    dense_residual: bool = False
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 style SSD parameters (see DESIGN.md §hardware-adaptation)."""
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64             # channels per decay-head
    conv_dim: int = 4
    chunk: int = 128               # chunkwise-parallel scan chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    head_dim: int = 64             # mLSTM qkv head dim
    proj_factor: float = 2.0       # mLSTM up-projection factor
    slstm_proj_factor: float = 1.333
    chunk: int = 128


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() provides precomputed embeddings.

    kind='audio'  -> encoder consumes (batch, frames, d_model) frames
    kind='vision' -> (batch, num_patches, d_model) patch embeddings prepended
                     to the text sequence
    """
    kind: str = "none"             # none | audio | vision
    num_patches: int = 0           # vision: patches prepended
    frame_ratio: int = 4           # audio: frames = seq_len // frame_ratio


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # dense FFN hidden (0 => no FFN in block)
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    block_pattern: tuple = (ATTN,) # repeats to cover num_layers
    moe: Optional[MoEConfig] = None
    ssm: SSMConfig = SSMConfig()
    xlstm: XLSTMConfig = XLSTMConfig()
    # encoder-decoder (audio family)
    num_encoder_layers: int = 0
    frontend: FrontendConfig = FrontendConfig()
    # source/verification tier from the assignment table
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: pattern len {len(self.block_pattern)} must divide "
            f"num_layers {self.num_layers}")
        for b in self.block_pattern:
            assert b in VALID_BLOCKS, b
        if self.num_heads and self.num_kv_heads:
            assert self.num_heads % self.num_kv_heads == 0

    # ---- derived ---------------------------------------------------------
    @property
    def is_encoder_decoder(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return ATTN not in self.block_pattern

    @property
    def sub_quadratic(self) -> bool:
        """True if the stack is O(S) per token in context length (SSM /
        hybrid-with-few-attn / linear-attn families) — gate for long_500k."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def layer_has_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe.every == self.moe.offset

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.block_pattern)

    # ---- parameter counting (exact, mirrors init code) --------------------
    def param_count(self) -> int:
        from repro_torch.models.params import count_params_config
        return count_params_config(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params_config
        return count_params_config(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int                   # context length (KV/state length for decode)
    global_batch: int

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode")


# The four assigned LM shape cells.
TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, per the assignment rules.

    long_500k needs sub-quadratic attention -> only ssm/hybrid families.
    (No assigned arch is encoder-only, so decode shapes always apply.)
    """
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, ("long_500k skipped: pure full-attention arch "
                       "(see DESIGN.md §4)")
    return True, ""


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup: int = 100
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # beyond-paper: quantize gradient all-reduce payloads (qdma_pack)
    grad_compression: str = "none" # none | int8


@dataclass(frozen=True)
class MeshConfig:
    shape: tuple = (1, 1)
    axes: tuple = ("data", "model")

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def data_axes(self) -> tuple:
        """Axes the batch is sharded over (everything except 'model'/'pipe')."""
        return tuple(a for a in self.axes if a not in ("model", "pipe"))

    @property
    def model_size(self) -> int:
        if "model" not in self.axes:
            return 1
        return self.shape[self.axes.index("model")]


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))
UNIT_MESH = MeshConfig((1, 1), ("data", "model"))


@dataclass(frozen=True)
class ShardingConfig:
    fsdp: bool = True              # shard params/opt-state over data axes
    seq_shard_acts: bool = False   # sequence-shard long activations (SP)
    shard_kv_seq: bool = True      # decode KV cache sequence-sharded on model
    remat: str = "dots"            # none | dots | full
    scan_layers: bool = True
    # unroll the grad-accumulation scan (dry-run cost variants only: keeps
    # XLA's while-body-once cost_analysis honest for microbatch > 1)
    unroll_microbatch: bool = False
    # beyond-paper hillclimb knobs (see EXPERIMENTS.md §Perf)
    gather_dim: str = "auto"       # auto | fsdp-transpose


@dataclass(frozen=True)
class PrecisionConfig:
    params: str = "float32"        # float32 | bfloat16
    compute: str = "bfloat16"
    logits: str = "float32"


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = UNIT_MESH
    optimizer: OptimizerConfig = OptimizerConfig()
    sharding: ShardingConfig = ShardingConfig()
    precision: PrecisionConfig = PrecisionConfig()
    # auto: a CUDA tensor launches the hand kernels, a CPU tensor takes
    # their plain versions; reference: plain versions everywhere
    kernel_backend: str = "auto"        # auto | reference
    microbatch: int = 1                 # grad-accum microbatches
    seed: int = 0
    # VF placement policy the SVFFManager's scheduler uses for this tenant
    # (see core/scheduler.py): first_fit | best_fit | fair_share
    placement: str = "first_fit"

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Architecture registry.  configs/<arch>.py modules call register() at import.
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_DEFAULTS: dict[str, dict] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig], **defaults):
    """Register an architecture.

    ``full``  — the exact assigned config (dry-run only: never allocated).
    ``smoke`` — a reduced config of the same family for CPU tests.
    ``defaults`` — per-arch RunConfig field overrides (e.g. optimizer for
    the 400B-class archs that need Adafactor to fit v5e HBM).
    """
    _REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke
    _DEFAULTS[name] = defaults


def _ensure_imported():
    # One module per assigned arch, imported lazily to avoid import cycles.
    from repro_torch.configs import (arctic_480b, olmoe_1b_7b,  # noqa
                                     qwen3_0_6b, llama3_8b, deepseek_67b,
                                     phi3_mini_3_8b, seamless_m4t_medium,
                                     xlstm_350m, jamba_1_5_large_398b,
                                     internvl2_1b, paper)


def list_archs() -> list[str]:
    _ensure_imported()
    return sorted(_REGISTRY)


def get_model_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_imported()
    reg = _SMOKE_REGISTRY if smoke else _REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; have {sorted(reg)}")
    return reg[name]()


def arch_defaults(name: str) -> dict:
    _ensure_imported()
    return dict(_DEFAULTS.get(name, {}))


def make_run_config(arch: str, shape: str, mesh: MeshConfig = UNIT_MESH,
                    smoke: bool = False, **overrides) -> RunConfig:
    model = get_model_config(arch, smoke=smoke)
    kw = arch_defaults(arch)
    kw.update(overrides)
    shape_cfg = SHAPES[shape] if isinstance(shape, str) else shape
    opt = kw.pop("optimizer", OptimizerConfig())
    if isinstance(opt, str):
        opt = OptimizerConfig(name=opt)
    prec = kw.pop("precision", None)
    if prec is None:
        # 100B+ archs store params in bf16 (see DESIGN.md memory budget)
        big = model.param_count() > 30_000_000_000
        prec = PrecisionConfig(params="bfloat16" if big else "float32")
    return RunConfig(model=model, shape=shape_cfg, mesh=mesh, optimizer=opt,
                     precision=prec, **kw)
