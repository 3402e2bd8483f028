"""Shared layers: layernorm, SwiGLU MLP, embedding, LM head and
cross-entropy (the port of ``repro.models.layers`` at tensor-parallel
degree 1, for what the dense StableLM layout runs).

Parameters are nested dicts of fp32 tensors in the reference's layout:
weights (d_in, d_out) applied as ``x @ W``, cast to the activation dtype
at each use. Norm and cross-entropy math is fp32 whatever the activation
dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int, scale=None, *,
               lead=(), device=None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return torch.randn((*lead, d_in, d_out), generator=gen,
                       device=device) * scale


def init_norm(cfg, *, lead=(), device=None) -> dict:
    d = cfg.d_model
    return {"bias": torch.zeros((*lead, d), device=device),
            "scale": torch.ones((*lead, d), device=device)}


def norm_fwd(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layernorm in fp32, returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def init_mlp(gen, cfg, *, lead=(), device=None) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    return {"down": dense_init(gen, dff, d, lead=lead, device=device),
            "gate": dense_init(gen, d, dff, lead=lead, device=device),
            "up": dense_init(gen, d, dff, lead=lead, device=device)}


def mlp_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu(x @ gate) * (x @ up) @ down."""
    dt = x.dtype
    h = F.silu(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))
    return h @ p["down"].to(dt)


def init_embed(gen, cfg, *, device=None) -> dict:
    return {"head": dense_init(gen, cfg.d_model, cfg.vocab_size,
                               scale=cfg.d_model ** -0.5, device=device),
            "tok": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                               device=device) * 0.02}


def embed_fwd(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d) in the model's compute dtype."""
    return p["tok"][tokens].to(getattr(torch, cfg.dtype))


def lm_head_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["head"].to(x.dtype)


def sharded_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy of (B, S, V) logits, fp32 math (the
    reference's vocab-sharded form at tp=1)."""
    lf = logits.float()
    m = lf.amax(-1, keepdim=True).detach()
    denom = torch.exp(lf - m).sum(-1)
    tgt = torch.gather(lf, -1, targets[..., None])[..., 0]
    return -(tgt - (m[..., 0] + torch.log(denom)))
