"""Jamba-1.5-Large: hybrid Mamba+attention 1:7 interleave (period of 8:
one attention layer per 7 mamba layers), MoE 16e top-2 on every other
layer, dense MLP on the rest. 398B total / ~94B active.
[arXiv:2403.19887; hf]

Mamba layers use the Mamba-2 (SSD) scalar-per-head-decay chunked
formulation, as in the JAX package.

``jamba-1.5-large-398b-1p-dense`` is the variant the port serves today:
``full()`` at every published width (d_model 8,192; 64 query and 8 KV
heads of 128; FFN 24,576; vocab 65,536, untied head; mamba d_state 128,
expand 2, 256 SSM heads of 64, conv 4, chunk 128) with two cuts:

  num_layers  72 -> 8: one whole period of the 1:7 pattern (1 attention
              layer, 7 mamba layers)
  moe         16 experts -> None: every layer keeps the dense SwiGLU of
              the published width. The four MoE layers of a period would
              hold 16 x 3 x 8,192 x 24,576 = 9.66 B parameters each, 77
              GB in bf16 on an 80 GB card; the experts come with the MoE
              families (ROADMAP Queue 1 item 7)

It has 8,905,349,120 parameters, stored in bf16 (17.8 GB): the published
398 B model is over ``make_run_config``'s 30 B line, so it stores its
params in bf16, and this variant stands for one pipeline stage of it.
The full config with experts is registered too and raises
``NotImplementedError`` when its params are built.
"""
import dataclasses

from repro_torch.configs.base import (ATTN, MAMBA, ModelConfig, MoEConfig,
                                      PrecisionConfig, SSMConfig, register)


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=24576, vocab_size=65536, rope_theta=1e4,
        block_pattern=(ATTN,) + (MAMBA,) * 7,
        moe=MoEConfig(num_experts=16, num_experts_per_token=2, d_ff=24576,
                      every=2, offset=1),
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_dim=4),
        source="arXiv:2403.19887; hf",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512,
        block_pattern=(ATTN, MAMBA, MAMBA, MAMBA),
        moe=MoEConfig(num_experts=4, num_experts_per_token=2, d_ff=128,
                      every=2, offset=1),
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, conv_dim=4, chunk=16),
    )


def one_period_dense() -> ModelConfig:
    return dataclasses.replace(full(), name="jamba-1.5-large-398b-1p-dense",
                               num_layers=8, moe=None)


def one_period_dense_smoke() -> ModelConfig:
    return dataclasses.replace(smoke(), moe=None,
                               name="jamba-1.5-large-398b-1p-dense-smoke")


register("jamba-1.5-large-398b", full, smoke, optimizer="adafactor")
register("jamba-1.5-large-398b-1p-dense", one_period_dense,
         one_period_dense_smoke, optimizer="adafactor",
         precision=PrecisionConfig(params="bfloat16"))
