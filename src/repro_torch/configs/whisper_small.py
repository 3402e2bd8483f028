"""Whisper-small encoder-decoder. [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is a stub: the batch carries
precomputed frame embeddings (1500 x d_model) for the encoder; the
encoder (12 layers, bidirectional) and the decoder (12 layers, causal,
with cross-attention over the encoder's output) are whole.
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        source="arXiv:2212.04356",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        rope=False, norm="layernorm", act="gelu",
        qkv_bias=True,
        is_encoder_decoder=True, n_enc_layers=12,
        frontend="audio_stub", n_frontend_tokens=1500,
    )
