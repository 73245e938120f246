"""DeepSeek-67B: llama-arch dense, 95 layers (deep) — the scan-over-layers
stress case. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", family="dense",
        num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=22016, vocab_size=102400, rope_theta=1e4,
        source="arXiv:2401.02954; hf",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=512,
    )


register("deepseek-67b", full, smoke, optimizer="adamw")
