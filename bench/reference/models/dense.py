"""The plain reference of the dense decoder family and its loss.

StableLM's layout (LayerNorm with bias, partial rotary) and the Llama
layout (RMSNorm, grouped key/value heads), both with a SwiGLU MLP and
causal attention; the output head is its own matrix or, with
``tie_word_embeddings``, the token table's transpose, and with
``use_qkv_bias`` the query, key and value projections add a bias. The
weights are the benchmark's tree (``bench.families.dense``): stacked
per layer, applied as ``x @ W``. Rotary embedding turns interleaved
pairs of the first ``partial_rotary_factor`` of each head's dims, as the
program under test defines its models. Each layer is recomputed in the
backward pass (``torch.utils.checkpoint``), so one layer's attention
scores at a time are held. ``mode`` is the linear layers' precision
(``bench.reference.linear``). Imports nothing but torch.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference.linear import linear


def norm(x: torch.Tensor, p: dict, cfg: dict) -> torch.Tensor:
    if cfg["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return ((x - mu) / torch.sqrt(var + cfg["layer_norm_eps"])
                * p["scale"] + p["bias"])
    if cfg["norm"] == "rmsnorm":
        ms = (x * x).mean(-1, keepdim=True)
        return x / torch.sqrt(ms + cfg["rms_norm_eps"]) * p["scale"]
    raise ValueError(f"unknown norm {cfg['norm']!r}")


def rope(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """x (B, S, H, hd): the interleaved pairs (2i, 2i + 1) of the first
    rot dims turned by pos * theta^(-2i / rot)."""
    hd = x.shape[-1]
    rot = int(hd * cfg["partial_rotary_factor"])
    if rot == 0:
        return x
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    inv = cfg["rope_theta"] ** (-torch.arange(0, rot, 2, device=x.device,
                                              dtype=torch.float32) / rot)
    ang = pos[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :,
                                                              None, :]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    turned = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([turned.reshape(*x.shape[:-1], rot), x[..., rot:]], -1)


def attention(h: torch.Tensor, p: dict, cfg: dict, mode: str):
    b, s, d = h.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nh
    q, k, v = (linear(h, p[w], mode) for w in ("wq", "wk", "wv"))
    if cfg["use_qkv_bias"]:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(b, s, nh, hd), cfg)
    k = rope(k.reshape(b, s, nkv, hd), cfg)
    v = v.reshape(b, s, nkv, hd)
    # query head i reads key/value head i // (nh / nkv)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    sc = sc.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
    return linear(o.reshape(b, s, nh * hd), p["wo"], mode)


def mlp(h: torch.Tensor, p: dict, mode: str) -> torch.Tensor:
    gate = linear(h, p["gate"], mode)
    return linear(torch.nn.functional.silu(gate) * linear(h, p["up"], mode),
                  p["down"], mode)


def layer_params(w: dict, i: int) -> dict:
    """Layer i's weights from the stacked tree: {attn, mlp, norm1, norm2}."""
    blk = w["blocks"]["l0"]
    return {name: {key: leaf[i] for key, leaf in sub.items()}
            for name, sub in blk.items()}


def block(x: torch.Tensor, p: dict, cfg: dict, mode: str) -> torch.Tensor:
    x = x + attention(norm(x, p["norm1"], cfg), p["attn"], cfg, mode)
    return x + mlp(norm(x, p["norm2"], cfg), p["mlp"], mode)


def nll_sum(w: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: dict, mode: str = "fp32") -> tuple:
    """(sum of the next-token negative log-likelihoods over the targets
    >= 0, their count) for tokens (B, S)."""
    x = w["embed"]["tok"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        x = checkpoint(block, x, layer_params(w, i), cfg, mode,
                       use_reentrant=False)
    x = norm(x, w["final_norm"], cfg)
    head = w["embed"]["tok"].T if cfg["tie_word_embeddings"] \
        else w["embed"]["head"]
    logits = linear(x, head, mode)
    valid = targets >= 0
    lse = torch.logsumexp(logits, -1)
    tgt = torch.gather(logits, -1, targets.clamp(min=0)[..., None])[..., 0]
    return ((lse - tgt) * valid).sum(), int(valid.sum())
