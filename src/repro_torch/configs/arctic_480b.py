"""Snowflake Arctic (base): dense-MoE hybrid, 128 experts top-2 with a dense
FFN in residual parallel. [hf:Snowflake/snowflake-arctic-base; hf]

``arctic-480b-1l`` is the variant the port serves on one card: ``full()``
at every published width (d_model 7,168; 56 query and 8 KV heads of 128;
dense FFN 4,864 beside 128 experts of FFN 4,864, top-2; vocab 32,000,
untied head) with one cut:

  num_layers  35 -> 1: one layer holds 128 x 3 x 7,168 x 4,864 = 13.39 B
              expert parameters, 26.8 GB in bf16; two would not leave
              room for the serve cache and the activations on an 80 GB
              card

It has 14,069,945,344 parameters, stored in bf16 (28.1 GB): in fp32, as
``make_run_config``'s 30 B line would give this variant, they would take
56 GB before the compute copy.
"""
import dataclasses

from repro_torch.configs.base import (ModelConfig, MoEConfig,
                                      PrecisionConfig, register)


def full() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=4864, vocab_size=32000, rope_theta=1e4,
        moe=MoEConfig(num_experts=128, num_experts_per_token=2, d_ff=4864,
                      dense_residual=True),
        source="hf:Snowflake/snowflake-arctic-base; hf",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=96, vocab_size=512,
        moe=MoEConfig(num_experts=4, num_experts_per_token=2, d_ff=96,
                      dense_residual=True),
    )


def one_layer() -> ModelConfig:
    return dataclasses.replace(full(), name="arctic-480b-1l", num_layers=1)


def one_layer_smoke() -> ModelConfig:
    return dataclasses.replace(smoke(), name="arctic-480b-1l-smoke",
                               num_layers=1)


# 480B-class: bf16 params + Adafactor (see the JAX package's DESIGN.md).
register("arctic-480b", full, smoke, optimizer="adafactor")
register("arctic-480b-1l", one_layer, one_layer_smoke, optimizer="adafactor",
         precision=PrecisionConfig(params="bfloat16"))
