from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SparsifierConfig,
    OptimizerConfig, RunConfig,
    SHAPES, get_config, register, reduced_config, resolve_model_cfg,
)
