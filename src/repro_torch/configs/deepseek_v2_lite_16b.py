"""DeepSeek-V2-Lite 16B: MLA (kv_lora=512) + MoE 64e top-6, 2 shared.
[arXiv:2405.04434]

Layer 0 has a dense FFN (n_dense_prefix=1), layers 1..26 are MoE."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("deepseek-v2-lite-16b")
def deepseek_v2_lite() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        source="arXiv:2405.04434",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944,  # dense-prefix FFN dim (dsv2-lite intermediate)
        vocab_size=102400,
        rope=True, rope_theta=10_000.0,
        qkv_bias=False, norm="rmsnorm", act="silu",
        attn_kind="mla", kv_lora_rank=512, q_lora_rank=0,
        rope_head_dim=64, head_dim=128, v_head_dim=128,
        n_dense_prefix=1,
        moe=MoEConfig(n_experts=64, n_shared_experts=2, top_k=6,
                      d_expert=1408, moe_every=1),
    )
