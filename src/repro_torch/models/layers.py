"""Shared layers: layernorm and rmsnorm, the SwiGLU and the GELU MLP,
embedding (tied or not), LM head and cross-entropy (the port of
``repro.models.layers`` at tensor-parallel degree 1, for every dense
layout).

Parameters are nested dicts of fp32 tensors in the reference's layout:
weights (d_in, d_out) applied as ``x @ W``, cast to the activation dtype
at each use. Norm and cross-entropy math is fp32 whatever the activation
dtype.

The GELU is the reference's ``jax.nn.gelu`` default, the tanh form,
spelled as jax spells it (``F.gelu`` defaults to the erf form). Its tanh
is ``torch.tanh``, which differs from XLA's CPU tanh by a few ulp: the
model's parity tolerance covers that (``core.numerics.tanh_f32``, XLA's
tanh bit for bit, is kept for the selection, where one ulp can flip a
key).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int, scale=None, *,
               lead=(), device=None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return torch.randn((*lead, d_in, d_out), generator=gen,
                       device=device) * scale


def init_norm(cfg, *, lead=(), device=None) -> dict:
    """{scale} for rmsnorm, {bias, scale} for layernorm."""
    d = cfg.d_model
    p = {"scale": torch.ones((*lead, d), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, d), device=device)
    return p


def norm_fwd(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
             eps: float = 1e-5) -> torch.Tensor:
    """Rmsnorm or layernorm in fp32, returned in x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        y = y * p["scale"]
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def init_mlp(gen, cfg, *, d_ff=None, lead=(), device=None) -> dict:
    """SwiGLU {down, gate, up}, or the GELU MLP {down, down_b, up, up_b}
    with zero biases; hidden width ``d_ff`` (default: the config's; an
    MoE's shared experts pass their own)."""
    d, dff = cfg.d_model, (d_ff or cfg.d_ff)
    # drawn down, gate, up: a seed gives the SwiGLU layout the weights
    # it had before the GELU layout was ported
    p = {"down": dense_init(gen, dff, d, lead=lead, device=device)}
    if cfg.act == "silu":
        p["gate"] = dense_init(gen, d, dff, lead=lead, device=device)
    p["up"] = dense_init(gen, d, dff, lead=lead, device=device)
    if cfg.act != "silu":
        p["up_b"] = torch.zeros((*lead, dff), device=device)
        p["down_b"] = torch.zeros((*lead, d), device=device)
    return p


_SQRT_2_OVER_PI = float(torch.tensor(math.sqrt(2 / math.pi),
                                     dtype=torch.float32))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (approximate=True), term for term:
    x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (x + 0.044715 * (x * x * x))))
    return x * cdf


def mlp_fwd(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """SwiGLU: silu(x @ gate) * (x @ up) @ down; GELU: gelu(x @ up +
    up_b) @ down + down_b."""
    dt = x.dtype
    if cfg.act == "silu":
        h = F.silu(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))
        return h @ p["down"].to(dt)
    h = gelu_tanh(x @ p["up"].to(dt) + p["up_b"].to(dt))
    return h @ p["down"].to(dt) + p["down_b"].to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, spelled as jax spells it: ``jnp.logaddexp(x,
    0)`` = max(x, 0) + log1p(exp(-|x|)) (``F.softplus`` is another
    formula, linear past its threshold of 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def init_embed(gen, cfg, *, device=None) -> dict:
    """{tok} and, untied, the LM head {head} (drawn first)."""
    p = {}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                               scale=cfg.d_model ** -0.5, device=device)
    p["tok"] = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                           device=device) * 0.02
    return p


def embed_fwd(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d) in the model's compute dtype."""
    return p["tok"][tokens].to(getattr(torch, cfg.dtype))


def lm_head_fwd(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits x @ head, or x @ tok.T with tied embeddings."""
    if cfg.tie_embeddings:
        return x @ p["tok"].to(x.dtype).T
    return x @ p["head"].to(x.dtype)


def sharded_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy of (B, S, V) logits, fp32 math (the
    reference's vocab-sharded form at tp=1)."""
    lf = logits.float()
    m = lf.amax(-1, keepdim=True).detach()
    denom = torch.exp(lf - m).sum(-1)
    tgt = torch.gather(lf, -1, targets[..., None])[..., 0]
    return -(tgt - (m[..., 0] + torch.log(denom)))
