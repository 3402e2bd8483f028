"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory), both
with exponential gating (the port of ``repro.models.xlstm`` at
tensor-parallel degree 1).

Each mixer is a pre-LN residual block with its own norm and its own
up and down projections (the layer has no ``norm1``). Parameters, in the
reference's layout::

    mlstm/{down (h, hdv, d), ln_h (h, hdv), norm, up (d, d_inner),
           up_gate (d, h, hdv), wif (d_inner, 2h), wk, wq (d_inner, h hd),
           wv (d_inner, h, hdv)}
    slstm/{down (d_inner, d), ln_h (d_inner,), norm, wf, wi, wo, wz
           (d, d_inner)}

The scan is sequential over the sequence, as the reference's
``lax.scan``: a Python loop of eager steps, fp32 state. The stabiliser
follows the reference term for term: ``m`` starts at 0, m' = max(f + m,
i), i' = exp(i - m'), f' = exp(f + m - m'). ``log_sigmoid`` is spelled
as jax spells it (``layers.log_sigmoid``), not as ``F.logsigmoid``. A
Python constant meeting a tensor is rounded to the tensor's dtype first,
as jax rounds a weak-typed scalar (:func:`const`).

The decode caches are the reference's: mLSTM ``{c (B, h, hdv, hd), n
(B, h, hd), m (B, h)}``, sLSTM ``{c, n, m}`` of (B, d_inner), all fp32;
a decode step writes them in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import mlstm_dims, slstm_dims
from repro_torch.core.numerics import bf16, f32
from repro_torch.models.layers import (
    dense_init, init_norm, log_sigmoid, norm_fwd)


def const(c: float, dtype) -> float:
    """The Python scalar c as jax rounds it next to a tensor of
    ``dtype``: to bf16 for a bf16 tensor, else to fp32."""
    return bf16(c) if dtype == torch.bfloat16 else f32(c)


def _gate_step(it, ft, m):
    """The stabilised exponential gates of one step: (i', f', m')."""
    fm = ft + m
    m_new = torch.maximum(fm, it)
    return torch.exp(it - m_new), torch.exp(fm - m_new), m_new


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen, cfg, *, lead=(), device=None) -> dict:
    d = cfg.d_model
    d_inner, h, hd = mlstm_dims(cfg)

    def dense(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, scale, lead=lead, device=device)
    return {
        "norm": init_norm(cfg, lead=lead, device=device),
        "up": dense(d, d_inner),
        "up_gate": dense(d, h * hd).reshape(*lead, d, h, hd),
        "wq": dense(d_inner, h * hd),
        "wk": dense(d_inner, h * hd),
        "wv": dense(d_inner, h * hd).reshape(*lead, d_inner, h, hd),
        "wif": dense(d_inner, 2 * h, 0.02),
        "ln_h": torch.ones((*lead, h, hd), device=device),
        "down": dense(h * hd, d).reshape(*lead, h, hd, d),
    }


def _mlstm_inputs(p: dict, x: torch.Tensor, cfg):
    """x (..., d) -> (q, k, v (..., h, hd) fp32, ig, fg (..., h) fp32,
    og (..., h, hdv) in x's dtype)."""
    _, h, hd = mlstm_dims(cfg)
    lead = x.shape[:-1]
    dt = x.dtype
    xi = norm_fwd(p["norm"], x, cfg.norm)
    u = xi @ p["up"].to(dt)
    og = torch.sigmoid(xi @ p["up_gate"].to(dt).reshape(xi.shape[-1], -1))
    q = (u @ p["wq"].to(dt)).reshape(*lead, h, hd)
    k = (u @ p["wk"].to(dt)).reshape(*lead, h, hd) * const(hd ** -0.5, dt)
    v = u @ p["wv"].to(dt).reshape(u.shape[-1], -1)
    gf = (u @ p["wif"].to(dt)).float()
    return (q.float(), k.float(), v.reshape(*lead, h, hd).float(),
            gf[..., :h], log_sigmoid(gf[..., h:]),
            og.reshape(*lead, h, hd))


def _mlstm_step(c, n, m, q, k, v, it, ft):
    """One step of the matrix memory: q, k, v (B, h, hd), it, ft (B, h);
    returns (c', n', m', h (B, h, hdv))."""
    i_, f_, m = _gate_step(it, ft, m)
    c = f_[..., None, None] * c + i_[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_[..., None] * n + i_[..., None] * k
    num = (c @ q[..., None])[..., 0]
    den = torch.clamp((n * q).sum(-1).abs(), min=1.0)
    return c, n, m, num / den[..., None]


def _mlstm_out(p: dict, hs: torch.Tensor, og: torch.Tensor,
               dtype) -> torch.Tensor:
    """(hs * ln_h) in the model's dtype, gated by og, through ``down``."""
    hs = (hs * p["ln_h"]).to(dtype) * og
    down = p["down"].to(dtype)
    return hs.flatten(-2) @ down.reshape(-1, down.shape[-1])


def init_mlstm_cache(cfg, batch: int, *, lead=(), device=None) -> dict:
    _, h, hd = mlstm_dims(cfg)
    return {"c": torch.zeros((*lead, batch, h, hd, hd), device=device),
            "n": torch.zeros((*lead, batch, h, hd), device=device),
            "m": torch.zeros((*lead, batch, h), device=device)}


def mlstm_fwd(p: dict, x: torch.Tensor, cfg, cache: dict = None):
    """x (B, S, d) -> (B, S, d). With ``cache`` (one layer's views of a
    decode cache) the final state is written into it."""
    b = x.shape[0]
    q, k, v, ig, fg, og = _mlstm_inputs(p, x, cfg)
    st = init_mlstm_cache(cfg, b, device=x.device)
    c, n, m = st["c"], st["n"], st["m"]
    hs = []
    for t in range(x.shape[1]):
        c, n, m, h = _mlstm_step(c, n, m, q[:, t], k[:, t], v[:, t],
                                 ig[:, t], fg[:, t])
        hs.append(h)
    if cache is not None:
        for key, val in (("c", c), ("n", n), ("m", m)):
            cache[key].copy_(val)
    return _mlstm_out(p, torch.stack(hs, 1), og, x.dtype)


def mlstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> torch.Tensor:
    """One token x (B, 1, d) -> (B, 1, d); the state in ``cache`` is
    updated in place."""
    q, k, v, ig, fg, og = _mlstm_inputs(p, x[:, 0], cfg)
    c, n, m, h = _mlstm_step(cache["c"], cache["n"], cache["m"], q, k, v,
                             ig, fg)
    for key, val in (("c", c), ("n", n), ("m", m)):
        cache[key].copy_(val)
    return _mlstm_out(p, h, og, x.dtype)[:, None]


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg, *, lead=(), device=None) -> dict:
    d, d_inner = cfg.d_model, slstm_dims(cfg)

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, lead=lead, device=device)
    p = {"norm": init_norm(cfg, lead=lead, device=device)}
    for key in ("wi", "wf", "wz", "wo"):
        p[key] = dense(d, d_inner)
    p["ln_h"] = torch.ones((*lead, d_inner), device=device)
    p["down"] = dense(d_inner, d)
    return p


def _slstm_inputs(p: dict, x: torch.Tensor, cfg):
    """x (..., d) -> the fp32 gates it, log_sigmoid(ft), tanh(zt),
    sigmoid(ot) (..., d_inner)."""
    dt = x.dtype
    xi = norm_fwd(p["norm"], x, cfg.norm)
    ig, fg, zg, og = ((xi @ p[key].to(dt)).float()
                      for key in ("wi", "wf", "wz", "wo"))
    return ig, log_sigmoid(fg), torch.tanh(zg), torch.sigmoid(og)


def _slstm_step(c, n, m, it, ft, zt, ot):
    i_, f_, m = _gate_step(it, ft, m)
    c = f_ * c + i_ * zt
    n = f_ * n + i_
    return c, n, m, ot * c / torch.clamp(n, min=1.0)


def init_slstm_cache(cfg, batch: int, *, lead=(), device=None) -> dict:
    return {key: torch.zeros((*lead, batch, slstm_dims(cfg)), device=device)
            for key in ("c", "n", "m")}


def slstm_fwd(p: dict, x: torch.Tensor, cfg, cache: dict = None):
    """x (B, S, d) -> (B, S, d). With ``cache`` the final state is
    written into it."""
    ig, fg, zg, og = _slstm_inputs(p, x, cfg)
    st = init_slstm_cache(cfg, x.shape[0], device=x.device)
    c, n, m = st["c"], st["n"], st["m"]
    hs = []
    for t in range(x.shape[1]):
        c, n, m, h = _slstm_step(c, n, m, ig[:, t], fg[:, t], zg[:, t],
                                 og[:, t])
        hs.append(h)
    if cache is not None:
        for key, val in (("c", c), ("n", n), ("m", m)):
            cache[key].copy_(val)
    hs = (torch.stack(hs, 1) * p["ln_h"]).to(x.dtype)
    return hs @ p["down"].to(x.dtype)


def slstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> torch.Tensor:
    """One token x (B, 1, d) -> (B, 1, d); the state in ``cache`` is
    updated in place."""
    ig, fg, zg, og = _slstm_inputs(p, x[:, 0], cfg)
    c, n, m, h = _slstm_step(cache["c"], cache["n"], cache["m"], ig, fg, zg,
                             og)
    for key, val in (("c", c), ("n", n), ("m", m)):
        cache[key].copy_(val)
    h = (h * p["ln_h"]).to(x.dtype)
    return (h @ p["down"].to(x.dtype))[:, None]
