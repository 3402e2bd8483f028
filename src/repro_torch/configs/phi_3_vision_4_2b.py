"""Phi-3-vision: phi3-mini decoder + CLIP vision stub.
[hf:microsoft/Phi-3-vision-128k-instruct]

The vision tower (CLIP ViT-L/14) is a stub: the batch carries precomputed
patch embeddings (n_frontend_tokens x d_model), which overwrite the token
embeddings of the first n_frontend_tokens positions
(``models.transformer.embed_batch``); those positions carry no LM loss.
"""
from repro_torch.configs.base import ModelConfig, register


@register("phi-3-vision-4.2b")
def phi_3_vision() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        source="hf:microsoft/Phi-3-vision-128k-instruct",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064,
        rope=True, rope_theta=10_000.0,
        qkv_bias=False, norm="rmsnorm", act="silu",
        frontend="vision_stub", n_frontend_tokens=576,  # 24x24 CLIP patches
    )
