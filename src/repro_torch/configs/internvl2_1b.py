"""InternVL2-1B: InternViT vision frontend (STUB — input_specs provides 256
precomputed patch embeddings) + Qwen2-0.5B-class LM backbone (GQA kv=2).
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=4864, vocab_size=151655, rope_theta=1e6, tie_embeddings=True,
        frontend=FrontendConfig(kind="vision", num_patches=256),
        source="arXiv:2404.16821; hf",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, tie_embeddings=True,
        frontend=FrontendConfig(kind="vision", num_patches=8),
    )


register("internvl2-1b", full, smoke)
