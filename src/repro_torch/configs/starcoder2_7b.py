"""StarCoder2-7B dense decoder, GQA kv=4, RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-7b")
def starcoder2_7b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        source="arXiv:2402.19173",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18432, vocab_size=49152,
        rope=True, rope_theta=100_000.0,
        qkv_bias=True, norm="layernorm", act="gelu",
    )
