"""Granite-MoE 3B (800M active): 40 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

The numeric field of the reference's config (40 experts, top-8) is taken
as canonical, as the reference does."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("granite-moe-3b-a800m")
def granite_moe() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49155,
        rope=True, rope_theta=10_000.0,
        qkv_bias=False, norm="rmsnorm", act="silu",
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512, moe_every=1),
    )
