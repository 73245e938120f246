"""Phi-3-mini-3.8B: dense, MHA (kv=32), RoPE + SwiGLU.
[arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32064, rope_theta=1e4,
        source="arXiv:2404.14219; unverified",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=512,
    )


register("phi3-mini-3.8b", full, smoke)
