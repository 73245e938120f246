"""Qwen3-0.6B: dense, GQA kv=8, qk_norm, head_dim=128 (decoupled from
d_model/H as in the Qwen3 family). [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
        d_ff=3072, vocab_size=151936, head_dim=128, qk_norm=True,
        rope_theta=1e6, tie_embeddings=True,
        source="hf:Qwen/Qwen3-8B; hf",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=32, qk_norm=True,
        tie_embeddings=True,
    )


register("qwen3-0.6b", full, smoke)
