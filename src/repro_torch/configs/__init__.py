from repro_torch.configs.base import (ATTN, MAMBA, MLSTM, SLSTM, FrontendConfig,
                                MeshConfig, ModelConfig, MoEConfig,
                                MULTI_POD_MESH, OptimizerConfig,
                                PrecisionConfig, RunConfig, SHAPES,
                                ShapeConfig, ShardingConfig, SINGLE_POD_MESH,
                                SSMConfig, UNIT_MESH, XLSTMConfig,
                                arch_defaults, get_model_config, list_archs,
                                make_run_config, register, shape_applicable)
from repro_torch.configs import paper  # noqa: F401  (registers svff-bench)

__all__ = [
    "ATTN", "MAMBA", "MLSTM", "SLSTM", "FrontendConfig", "MeshConfig",
    "ModelConfig", "MoEConfig", "MULTI_POD_MESH", "OptimizerConfig",
    "PrecisionConfig", "RunConfig", "SHAPES", "ShapeConfig", "ShardingConfig",
    "SINGLE_POD_MESH", "SSMConfig", "UNIT_MESH", "XLSTMConfig",
    "arch_defaults", "get_model_config", "list_archs", "make_run_config",
    "register", "shape_applicable",
]
