"""xLSTM-350M-class: mLSTM + sLSTM blocks (3:1 mix), no FFN (d_ff=0 — the
recurrent blocks carry their own projections). State is O(1) in context
length, so long_500k applies. [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import (MLSTM, SLSTM, ModelConfig, XLSTMConfig,
                                      register)


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
        # head_dim=512 => d_inner 2048 / 512 = 4 mLSTM heads (assignment: 4H)
        xlstm=XLSTMConfig(head_dim=512, proj_factor=2.0),
        source="arXiv:2405.04517; unverified",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke", family="ssm",
        num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=512,
        block_pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
        xlstm=XLSTMConfig(head_dim=32, proj_factor=2.0, chunk=16),
    )


register("xlstm-350m", full, smoke)
