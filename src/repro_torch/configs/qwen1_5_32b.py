"""Qwen1.5-32B dense decoder with QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-32b")
def qwen1_5_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        source="hf:Qwen/Qwen1.5-0.5B",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab_size=152064,
        rope=True, rope_theta=1_000_000.0,
        qkv_bias=True, norm="rmsnorm", act="silu",
    )
