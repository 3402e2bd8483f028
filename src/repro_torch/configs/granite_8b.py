"""Granite-8B code model, llama-arch, GQA kv=8. [arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-8b")
def granite_8b() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense",
        source="arXiv:2405.04324",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=49152,
        rope=True, rope_theta=10_000.0,
        qkv_bias=False, norm="rmsnorm", act="silu",
    )
