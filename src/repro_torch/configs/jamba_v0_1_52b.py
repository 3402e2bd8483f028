"""Jamba-v0.1 52B hybrid: Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887]

Super-block of 8 layers: attention at position 4 (attn_every=8, attn_offset=4),
Mamba elsewhere; MoE FFN on odd positions (moe_every=2, moe_offset=1).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register


@register("jamba-v0.1-52b")
def jamba() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        source="arXiv:2403.19887",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        rope=False,  # jamba uses no positional encoding (Mamba provides order)
        qkv_bias=False, norm="rmsnorm", act="silu",
        attn_every=8, attn_offset=4,
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336,
                      moe_every=2, moe_offset=1),
        ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    )
