"""xLSTM-125M: alternating mLSTM / sLSTM blocks. [arXiv:2405.04517]

d_ff=0 in the assignment: blocks carry their own up/down projections
(mLSTM proj factor 2, sLSTM proj factor 4/3), no separate FFN.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("xlstm-125m")
def xlstm_125m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        source="arXiv:2405.04517",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        rope=False, norm="layernorm", act="gelu",
        attn_every=0,  # no attention layers at all
        ssm=SSMConfig(kind="xlstm", d_state=16, d_conv=4),
    )
