"""Llama-3-8B: dense GQA kv=8, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=128256, rope_theta=5e5,
        source="arXiv:2407.21783; unverified",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=512,
    )


register("llama3-8b", full, smoke)
