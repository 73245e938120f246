"""SeamlessM4T-medium: encoder-decoder multimodal backbone; the audio
frontend is a STUB (input_specs provides precomputed frame embeddings at
seq_len // frame_ratio). [arXiv:2308.11596; hf]"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        num_layers=12, num_encoder_layers=12,
        d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=256206, rope_theta=1e4,
        frontend=FrontendConfig(kind="audio", frame_ratio=4),
        source="arXiv:2308.11596; hf",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke", family="audio",
        num_layers=2, num_encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512,
        frontend=FrontendConfig(kind="audio", frame_ratio=4),
    )


register("seamless-m4t-medium", full, smoke)
