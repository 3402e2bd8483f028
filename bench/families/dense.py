"""The dense decoder family: StableLM's layout (LayerNorm, partial
rotary) and the Llama layout (RMSNorm, grouped key/value heads), with a
SwiGLU MLP, an output head of its own or tied to the token table, and
optional query, key and value biases."""
from __future__ import annotations

KEYS = ("hidden_size", "intermediate_size", "num_attention_heads",
        "num_key_value_heads", "num_hidden_layers", "vocab_size",
        "partial_rotary_factor", "rope_theta", "norm", "hidden_act",
        "use_qkv_bias", "tie_word_embeddings", "torch_dtype")


def leaf_specs(cfg: dict) -> list:
    """[(path, shape, init)] of the tree in flat order (dict keys sorted
    at every level): init is "normal" (scaled by d_in^-0.5), "table"
    (scaled by 0.02), "ones" or "zeros". Every layer's leaf is stacked
    on a leading axis."""
    d, dff, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, n = d // nh, cfg["num_hidden_layers"]
    norm = {"scale": ((d,), "ones")}
    if cfg["norm"] == "layernorm":
        norm["bias"] = ((d,), "zeros")
    attn = {"wk": ((d, nkv * hd), "normal"), "wo": ((nh * hd, d), "normal"),
            "wq": ((d, nh * hd), "normal"), "wv": ((d, nkv * hd), "normal")}
    if cfg["use_qkv_bias"]:
        attn.update(bq=((nh * hd,), "zeros"), bk=((nkv * hd,), "zeros"),
                    bv=((nkv * hd,), "zeros"))
    embed = {"tok": ((v, d), "table")}
    if not cfg["tie_word_embeddings"]:
        embed["head"] = ((d, v), "normal")
    tree = {
        "blocks": {"l0": {
            "attn": attn,
            "mlp": {"down": ((dff, d), "normal"),
                    "gate": ((d, dff), "normal"),
                    "up": ((d, dff), "normal")},
            "norm1": dict(norm), "norm2": dict(norm)}},
        "embed": embed,
        "final_norm": dict(norm)}
    out = []

    def walk(node, path):
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                shape, init = val
                if path[:1] == ("blocks",):
                    shape = (n,) + shape
                out.append((path + (key,), shape, init))
    walk(tree, ())
    return out


def port_config(cfg: dict):
    """The program's ModelConfig of a configuration's file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense", source=cfg["source"],
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope=True, rope_theta=cfg["rope_theta"],
        rotary_pct=cfg["partial_rotary_factor"],
        qkv_bias=cfg["use_qkv_bias"], norm=cfg["norm"],
        act=cfg["hidden_act"], tie_embeddings=cfg["tie_word_embeddings"],
        dtype=cfg["torch_dtype"])
