"""OLMoE-1B-7B: 64-expert top-8 MoE, no dense path. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1024, vocab_size=50304, qk_norm=True, rope_theta=1e4,
        moe=MoEConfig(num_experts=64, num_experts_per_token=8, d_ff=1024),
        source="arXiv:2409.02060; hf",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=512, qk_norm=True,
        moe=MoEConfig(num_experts=8, num_experts_per_token=2, d_ff=64),
    )


register("olmoe-1b-7b", full, smoke)
