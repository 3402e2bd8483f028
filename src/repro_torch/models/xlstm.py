"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory), both
with exponential gating (the port of ``repro.models.xlstm``).

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

Tensor parallelism (a ``Parallel`` with a model group of tp ranks, the
reference's splits): the mLSTM keeps ``up``, ``wq``, ``wk`` and ``wif``
replicated, so every rank computes q, k and both gates whole, and the
denominator max(|n . q|, 1) needs no collective; it splits the value
dim of each head, hdv = hd / tp a rank, on its own axis of ``up_gate``
and ``wv`` (dim 2 of (d, h, hd)), ``ln_h`` and ``down`` (dim 1), so the
matrix memory c is (B, h, hdv, hd) on each rank and n and m are whole.
The sLSTM splits its four gate projections by column, ``ln_h`` as a
vector and ``down`` by row; its scan is elementwise a channel, so its
c, n and m are the rank's channels. Either mixer's output is summed
over the model group (with the residual stream split by sequence, the
sequence is gathered on entry and the output psum-scattered back). A
head dim or an sLSTM width that tp does not divide raises ValueError,
as the reference asserts.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import mlstm_dims, slstm_dims
from repro_torch.core.numerics import bf16, f32
from repro_torch.models.layers import (
    dense_init, init_norm, log_sigmoid, norm_fwd)
from repro_torch.models.parallel import (
    psum_model, row_parallel_out, seq_gathered, shard_slice,
)


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

def mlstm_value_dim(cfg, pal=None) -> int:
    """This rank's share hdv of each head's value dim."""
    return shard_slice(mlstm_dims(cfg)[2], pal, "the mLSTM's head dim")


def init_mlstm(gen, cfg, *, lead=(), device=None, pal=None) -> dict:
    """The mLSTM's leaves; under tensor parallelism this rank's hdv of
    each head's value dim."""
    d = cfg.d_model
    d_inner, h, hd = mlstm_dims(cfg)
    hdv = mlstm_value_dim(cfg, pal)

    def dense(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, scale, lead=lead, device=device)
    return {
        "norm": init_norm(cfg, lead=lead, device=device),
        "up": dense(d, d_inner),
        "up_gate": dense(d, h * hdv).reshape(*lead, d, h, hdv),
        "wq": dense(d_inner, h * hd),
        "wk": dense(d_inner, h * hd),
        "wv": dense(d_inner, h * hdv).reshape(*lead, d_inner, h, hdv),
        "wif": dense(d_inner, 2 * h, 0.02),
        "ln_h": torch.ones((*lead, h, hdv), device=device),
        "down": dense(h * hdv, d).reshape(*lead, h, hdv, d),
    }


def _mlstm_inputs(p: dict, x: torch.Tensor, cfg):
    """x (..., d) -> (q, k (..., h, hd), v (..., h, hdv) fp32, ig, fg
    (..., h) fp32, og (..., h, hdv) in x's dtype); hdv is ``wv``'s."""
    _, h, hd = mlstm_dims(cfg)
    hdv = p["wv"].shape[-1]
    lead = x.shape[:-1]
    dt = x.dtype
    xi = norm_fwd(p["norm"], x, cfg.norm)
    u = xi @ p["up"].to(dt)
    og = torch.sigmoid(xi @ p["up_gate"].to(dt).reshape(xi.shape[-1], -1))
    q = (u @ p["wq"].to(dt)).reshape(*lead, h, hd)
    k = (u @ p["wk"].to(dt)).reshape(*lead, h, hd) * const(hd ** -0.5, dt)
    v = u @ p["wv"].to(dt).reshape(u.shape[-1], -1)
    gf = (u @ p["wif"].to(dt)).float()
    return (q.float(), k.float(), v.reshape(*lead, h, hdv).float(),
            gf[..., :h], log_sigmoid(gf[..., h:]),
            og.reshape(*lead, h, hdv))


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


def init_mlstm_cache(cfg, batch: int, *, lead=(), device=None,
                     pal=None) -> dict:
    """Zero state: c (B, h, hdv, hd) of this rank's value dims, n and m
    whole."""
    _, h, hd = mlstm_dims(cfg)
    hdv = mlstm_value_dim(cfg, pal)
    return {"c": torch.zeros((*lead, batch, h, hdv, hd), device=device),
            "n": torch.zeros((*lead, batch, h, hd), device=device),
            "m": torch.zeros((*lead, batch, h), device=device)}


def mlstm_fwd(p: dict, x: torch.Tensor, cfg, cache: dict = None,
              pal=None):
    """x (B, S, d) -> (B, S, d). With ``cache`` (one layer's views of a
    decode cache) the final state is written into it. Under tensor
    parallelism this rank's value dims, the output summed over the model
    group; with ``pal.sp`` x and the output are its sequence chunk."""
    x = seq_gathered(x, pal)
    b = x.shape[0]
    q, k, v, ig, fg, og = _mlstm_inputs(p, x, cfg)
    st = init_mlstm_cache(cfg, b, device=x.device, pal=pal)
    c, n, m = st["c"], st["n"], st["m"]
    hs = []
    for t in range(x.shape[1]):
        c, n, m, h = _mlstm_step(c, n, m, q[:, t], k[:, t], v[:, t],
                                 ig[:, t], fg[:, t])
        hs.append(h)
    if cache is not None:
        for key, val in (("c", c), ("n", n), ("m", m)):
            cache[key].copy_(val)
    return row_parallel_out(_mlstm_out(p, torch.stack(hs, 1), og, x.dtype),
                            pal)


def mlstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg,
                 pal=None) -> torch.Tensor:
    """One token x (B, 1, d) -> (B, 1, d); the state in ``cache`` is
    updated in place (the output summed over the model group)."""
    q, k, v, ig, fg, og = _mlstm_inputs(p, x[:, 0], cfg)
    c, n, m, h = _mlstm_step(cache["c"], cache["n"], cache["m"], q, k, v,
                             ig, fg)
    for key, val in (("c", c), ("n", n), ("m", m)):
        cache[key].copy_(val)
    return psum_model(_mlstm_out(p, h, og, x.dtype)[:, None], pal)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_local(cfg, pal=None) -> int:
    """This rank's channels of the sLSTM's d_inner."""
    return shard_slice(slstm_dims(cfg), pal, "the sLSTM's d_inner")


def init_slstm(gen, cfg, *, lead=(), device=None, pal=None) -> dict:
    """The sLSTM's leaves; under tensor parallelism this rank's
    channels."""
    d, d_inner = cfg.d_model, slstm_local(cfg, pal)

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


def init_slstm_cache(cfg, batch: int, *, lead=(), device=None,
                     pal=None) -> dict:
    """Zero c, n and m of this rank's channels."""
    return {key: torch.zeros((*lead, batch, slstm_local(cfg, pal)),
                             device=device)
            for key in ("c", "n", "m")}


def slstm_fwd(p: dict, x: torch.Tensor, cfg, cache: dict = None,
              pal=None):
    """x (B, S, d) -> (B, S, d). With ``cache`` the final state is
    written into it. Under tensor parallelism this rank's channels, the
    output summed over the model group; with ``pal.sp`` x and the output
    are its sequence chunk."""
    x = seq_gathered(x, pal)
    ig, fg, zg, og = _slstm_inputs(p, x, cfg)
    st = init_slstm_cache(cfg, x.shape[0], device=x.device, pal=pal)
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
    return row_parallel_out(hs @ p["down"].to(x.dtype), pal)


def slstm_decode(p: dict, x: torch.Tensor, cache: dict, cfg,
                 pal=None) -> torch.Tensor:
    """One token x (B, 1, d) -> (B, 1, d); the state in ``cache`` is
    updated in place (the output summed over the model group)."""
    ig, fg, zg, og = _slstm_inputs(p, x[:, 0], cfg)
    c, n, m, h = _slstm_step(cache["c"], cache["n"], cache["m"], ig, fg, zg,
                             og)
    for key, val in (("c", c), ("n", n), ("m", m)):
        cache[key].copy_(val)
    h = (h * p["ln_h"]).to(x.dtype)
    return psum_model((h @ p["down"].to(x.dtype))[:, None], pal)
