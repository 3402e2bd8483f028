"""StableLM-2-3B-class dense decoder. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig, register


@register("stablelm-3b")
def stablelm_3b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab_size=50304,
        rope=True, rotary_pct=0.25, rope_theta=10_000.0,
        qkv_bias=False, norm="layernorm", act="silu",
    )
