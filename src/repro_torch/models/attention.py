"""Causal self-attention with partial RoPE (the port of the full-sequence
path of ``repro.models.attention`` at tensor-parallel degree 1).

The reference has no Pallas kernel here: its attention is plain jnp. The
port keeps it plain PyTorch too: a matmul, a mask and an fp32 softmax,
chunked over queries to bound memory (as ``_sdpa_chunked`` chunks them).
It does not call ``scaled_dot_product_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init

NEG_INF = -1e30
Q_CHUNK = 1024


def rope_angles(pos: torch.Tensor, rot_dim: int,
                theta: float) -> torch.Tensor:
    """(S, rot_dim/2) fp32 rotation angles pos * theta^(-2i/rot_dim)."""
    ar = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=pos.device)
    return pos[:, None].float() * theta ** (-ar / rot_dim)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, rot_dim: int,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd), pos (S,). Rotates the INTERLEAVED pairs
    (x[..., 0::2], x[..., 1::2]) of the first rot_dim dims (not the
    rotate-half layout)."""
    if rot_dim == 0:
        return x
    angle = rope_angles(pos, rot_dim, theta)
    cos = torch.cos(angle)[None, :, None, :]
    sin = torch.sin(angle)[None, :, None, :]
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    rot = rot.reshape(xr.shape)
    return torch.cat([rot.to(x.dtype), x[..., rot_dim:]], -1)


def init_attention(gen, cfg, *, lead=(), device=None) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {"wk": dense_init(gen, d, kv * hd, lead=lead, device=device),
            "wo": dense_init(gen, h * hd, d, lead=lead, device=device),
            "wq": dense_init(gen, d, h * hd, lead=lead, device=device),
            "wv": dense_init(gen, d, kv * hd, lead=lead, device=device)}


def proj_qkv(p: dict, x: torch.Tensor, cfg, pos: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q, k, v = (x @ p[w].to(dt) for w in ("wq", "wk", "wv"))
    q, k, v = (t.reshape(b, s, -1, hd) for t in (q, k, v))
    rot = int(hd * cfg.rotary_pct)
    return (apply_rope(q, pos, rot, cfg.rope_theta),
            apply_rope(k, pos, rot, cfg.rope_theta), v)


def causal_attention(q, k, v, scale: float) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, KV, hd) with H a multiple of KV (GQA).
    Scores and softmax in fp32, chunked over queries; the normaliser is
    applied after the value product, as the reference's online softmax
    does."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    pos = torch.arange(s, device=q.device)
    outs = []
    for q0 in range(0, s, Q_CHUNK):
        qc = q[:, q0:q0 + Q_CHUNK]
        sq = qc.shape[1]
        qg = qc.reshape(b, sq, kvh, g, hd)
        sc = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
        mask = pos[q0:q0 + sq, None] >= pos[None, :]
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m = sc.amax(-1, keepdim=True)
        w = torch.exp(sc - m)
        l = w.sum(-1)                                          # (b,k,g,q)
        o = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
        l = l.permute(0, 3, 1, 2)[..., None].clamp(min=1e-30)
        outs.append((o / l.to(o.dtype)).reshape(b, sq, h, hd))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def attn_fwd_full(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), causal."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    q, k, v = proj_qkv(p, x, cfg, pos)
    o = causal_attention(q, k, v, cfg.resolved_head_dim ** -0.5)
    return o.reshape(b, s, -1) @ p["wo"].to(o.dtype)
