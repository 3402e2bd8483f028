"""Shared layers: layernorm and rmsnorm, the SwiGLU and the GELU MLP,
embedding (tied or not), LM head and cross-entropy (the port of
``repro.models.layers``, for every dense layout).

Parameters are nested dicts of fp32 tensors in the reference's layout:
weights (d_in, d_out) applied as ``x @ W``, cast to the activation dtype
at each use. Norm and cross-entropy math is fp32 whatever the activation
dtype.

Under tensor parallelism (a ``Parallel`` with a model group of tp ranks)
the MLP is column-parallel up and row-parallel down: each rank holds
d_ff / tp hidden units, its output is summed over the model group (or,
with the residual stream split by sequence, all-gathered before and
psum-scattered after), and a GELU MLP's ``down_b`` is added once, after
the reduction. The embedding and the head split the vocabulary, padded
to a multiple of tp: rank r holds rows [r V/tp, (r + 1) V/tp). The
embedding takes each token's row where the rank holds it and zeros
elsewhere, summed (or psum-scattered) over the group: the reference's
one-hot matmul, whose other terms are exact zeros, at the cost of a
gather. The head's logits of padded ids are -1e30, and the
cross-entropy's max, normaliser and target logit are taken over the
group.

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

from repro_torch.models.parallel import (
    all_gather_model, axis_index, pad_to, pmax_model, psum_model,
    psum_scatter_model, shard_slice,
)


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


def init_mlp(gen, cfg, *, d_ff=None, lead=(), device=None,
             pal=None) -> dict:
    """SwiGLU {down, gate, up}, or the GELU MLP {down, down_b, up, up_b}
    with zero biases; hidden width ``d_ff`` (default: the config's; an
    MoE's shared experts pass their own), this rank's share of it under
    tensor parallelism."""
    d, dff = cfg.d_model, shard_slice(d_ff or cfg.d_ff, pal)
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


def mlp_fwd(p: dict, x: torch.Tensor, cfg, pal=None) -> torch.Tensor:
    """SwiGLU: silu(x @ gate) * (x @ up) @ down; GELU: gelu(x @ up +
    up_b) @ down + down_b. x (..., S, d), split by sequence when
    ``pal.sp``: gathered before the column-parallel products, the
    row-parallel output psum-scattered back (else summed over the model
    group)."""
    dt = x.dtype
    seq = x.ndim - 2
    sp = pal is not None and pal.sp
    if sp:
        x = all_gather_model(x, pal, seq)
    if cfg.act == "silu":
        h = F.silu(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))
    else:
        h = gelu_tanh(x @ p["up"].to(dt) + p["up_b"].to(dt))
    y = h @ p["down"].to(dt)
    y = psum_scatter_model(y, pal, seq) if sp else psum_model(y, pal)
    if cfg.act != "silu":
        y = y + p["down_b"].to(dt)        # once, after the reduction
    return y


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, spelled as jax spells it: ``jnp.logaddexp(x,
    0)`` = max(x, 0) + log1p(exp(-|x|)) (``F.softplus`` is another
    formula, linear past its threshold of 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def vocab_padded(cfg, pal=None) -> int:
    """The vocabulary padded to a multiple of the model group's size."""
    return pad_to(cfg.vocab_size, 1 if pal is None else pal.tp)


def init_embed(gen, cfg, *, device=None, pal=None) -> dict:
    """{tok} and, untied, the LM head {head} (drawn first); this rank's
    rows of the padded vocabulary under tensor parallelism."""
    v = shard_slice(vocab_padded(cfg, pal), pal)
    p = {}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, v,
                               scale=cfg.d_model ** -0.5, device=device)
    p["tok"] = torch.randn((v, cfg.d_model), generator=gen,
                           device=device) * 0.02
    return p


def embed_fwd(p: dict, tokens: torch.Tensor, cfg, pal=None,
              reduce: str = "psum") -> torch.Tensor:
    """tokens (B, S) -> (B, S, d) in the model's compute dtype. Under
    tensor parallelism each rank's rows (zeros for the tokens it does not
    hold), summed over the model group (``reduce="psum"``) or
    psum-scattered along the sequence (``"scatter"``: this rank's
    sequence chunk, which also makes the table's gradient exact under
    sequence parallelism)."""
    dt = getattr(torch, cfg.dtype)
    if pal is None or not pal.tp_on:
        return p["tok"][tokens].to(dt)
    vl = p["tok"].shape[0]
    local = tokens - axis_index(pal) * vl
    inb = (local >= 0) & (local < vl)
    x = p["tok"][local.clamp(0, vl - 1)] * inb[..., None]
    x = psum_scatter_model(x, pal, 1) if reduce == "scatter" \
        else psum_model(x, pal)
    return x.to(dt)


def lm_head_fwd(p: dict, x: torch.Tensor, cfg, pal=None) -> torch.Tensor:
    """Logits x @ head, or x @ tok.T with tied embeddings; under tensor
    parallelism this rank's (B, S, V/tp) columns, -1e30 at the padded
    ids (>= vocab_size)."""
    if cfg.tie_embeddings:
        logits = x @ p["tok"].to(x.dtype).T
    else:
        logits = x @ p["head"].to(x.dtype)
    vl = logits.shape[-1]
    tp = 1 if pal is None else pal.tp
    if vl * tp > cfg.vocab_size:
        gids = axis_index(pal) * vl + torch.arange(vl, device=x.device)
        logits = torch.where(gids < cfg.vocab_size, logits,
                             torch.full_like(logits, -1e30))
    return logits


def sharded_xent(logits: torch.Tensor, targets: torch.Tensor,
                 pal=None) -> torch.Tensor:
    """Per-position cross-entropy of (B, S, V) logits, fp32 math; under
    tensor parallelism of this rank's (B, S, V/tp) columns, with the max
    (outside autograd), the normaliser and the target's logit taken over
    the model group."""
    lf = logits.float()
    m = pmax_model(lf.amax(-1, keepdim=True), pal)
    denom = psum_model(torch.exp(lf - m).sum(-1), pal)
    if pal is None or not pal.tp_on:
        tgt = torch.gather(lf, -1, targets[..., None])[..., 0]
    else:
        vl = lf.shape[-1]
        local = targets - axis_index(pal) * vl
        inb = (local >= 0) & (local < vl)
        tgt = torch.gather(lf, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
        tgt = psum_model(torch.where(inb, tgt, torch.zeros_like(tgt)), pal)
    return -(tgt - (m[..., 0] + torch.log(denom)))
