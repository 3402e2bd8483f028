"""Mamba-1 selective SSM mixer (the port of ``repro.models.mamba``).

Parameters, in the reference's layout (``A_log`` and ``D`` sort first in
the flat vector, upper case before lower, in both packages)::

    mamba/{A_log (d_inner, d_state), D (d_inner,), conv_b (d_inner,),
           conv_w (d_conv, d_inner), dt_bias (d_inner,),
           dt_proj (dt_rank, d_inner), in_x, in_z (d, d_inner),
           out_proj (d_inner, d), x_proj (d_inner, dt_rank + 2 d_state)}

The causal depthwise conv is the reference's sum of shifted products.
The selective scan is chunked as the reference's: ``chunk = min(512,
S)``, or S when 512 does not divide it; a sequential loop over chunks
carries the state, and inside a chunk the recurrence h_t = da_t h_{t-1}
+ dbu_t is the reference's ``jax.lax.associative_scan`` with the
combine (a1 a2, b2 + a2 b1), replicated step for step
(:func:`associative_scan`: the same odd/even recursion over strided
slices, so the same products in the same order, in about 2 log2(chunk)
vectorised steps). XLA's CPU program contracts b2 + a2 b1 into a fused
multiply-add and the port does not, so the two differ by rounding only
(the tests state the bound). A chunk's decay and input tensors (B,
chunk, d_inner, d_state) are built inside the chunk, and under
``cfg.remat`` with autograd on each chunk is recomputed in the backward
pass (``torch.utils.checkpoint``), so one chunk's working set is held at
a time.

The decode cache is the reference's ``{conv (B, d_conv - 1, d_inner) in
the model's dtype: the last inputs before the conv, h (B, d_inner,
d_state) fp32}``; a decode step writes it in place.

Tensor parallelism (a ``Parallel`` with a model group of tp ranks, the
reference's channel split): every channel's scan is independent, so rank
r holds channels [r d_inner/tp, (r + 1) d_inner/tp) of ``in_x``,
``in_z``, ``conv_w``, ``conv_b``, ``dt_proj``, ``dt_bias``, ``A_log`` and
``D``, the matching rows of ``x_proj`` and ``out_proj``, and scans the
whole sequence for them. The data-dependent projection (dt, B, C) needs
every channel, so ``x_proj``'s partial product is summed over the model
group in the state dtype before the split; ``out_proj``'s is summed (or,
with the residual stream split by sequence, psum-scattered back to the
rank's chunk after the sequence was gathered on entry). The decode
cache's conv ring and h hold the rank's channels. A d_inner that tp does
not divide raises ValueError, as the reference asserts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import mamba_dims
from repro_torch.models.layers import dense_init, softplus
from repro_torch.models.parallel import (
    psum_model, row_parallel_out, seq_gathered, shard_slice,
)

SCAN_CHUNK = 512


def local_dims(cfg, pal=None) -> tuple:
    """(this rank's channels of d_inner, dt_rank)."""
    di, dtr = mamba_dims(cfg)
    return shard_slice(di, pal, "Mamba's d_inner"), dtr


def init_mamba(gen, cfg, *, lead=(), device=None, pal=None) -> dict:
    """The reference's init: S4D-real ``A_log`` = log(1..d_state) on every
    channel, ``dt_bias`` the inverse softplus of dt drawn log-uniform in
    [1e-3, 1e-1], ``D`` = 1, the conv N(0, 0.2^2); this rank's channels
    under tensor parallelism."""
    d, ds, dc = cfg.d_model, cfg.ssm.d_state, cfg.ssm.d_conv
    di, dtr = local_dims(cfg, pal)

    def dense(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, scale, lead=lead, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((*lead, di), generator=gen, device=device)
                   * (hi - lo) + lo)
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=device)
    return {
        "in_x": dense(d, di),
        "in_z": dense(d, di),
        "conv_w": torch.randn((*lead, dc, di), generator=gen,
                              device=device) * 0.2,
        "conv_b": torch.zeros((*lead, di), device=device),
        "x_proj": dense(di, dtr + 2 * ds),
        "dt_proj": dense(dtr, di, dtr ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(a).expand(*lead, di, ds).contiguous(),
        "D": torch.ones((*lead, di), device=device),
        "out_proj": dense(di, d),
    }


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (K, C) -> (B, S, C): the
    reference's sum of the K shifted products, in order, plus b."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b.to(out.dtype)


def _combine(a1, b1, a2, b2):
    return a1 * a2, b2 + a2 * b1


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1],
                          *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Inclusive scan along dim 1 of the pairs (a, b) under (a1, b1) .
    (a2, b2) = (a1 a2, b2 + a2 b1): ``jax.lax.associative_scan``'s
    recursion (pairs combined, the half scanned, the even elements
    combined from the odd results, the two interleaved)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = associative_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2],
                                        a[:, 1::2], b[:, 1::2]))
    tail = slice(0, -1) if n % 2 == 0 else slice(None)
    ea, eb = _combine(oa[:, tail], ob[:, tail], a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], 1)
    eb = torch.cat([b[:, :1], eb], 1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _chunk(h, u, dt, bmat, cmat, a):
    """One chunk: u, dt (B, L, C), bmat, cmat (B, L, N), the carried h
    (B, C, N) -> (y (B, L, C) without the skip term, h at its end)."""
    da = torch.exp(dt[..., None] * (-a))                      # (B,L,C,N)
    dbu = (dt * u)[..., None] * bmat[:, :, None, :]
    aa, bb = associative_scan(da, dbu)
    h_all = aa * h[:, None] + bb
    return (h_all @ cmat[..., None])[..., 0], h_all[:, -1]


def ssm_scan_chunked(u, dt, bmat, cmat, a, d_skip, h0, remat=False):
    """The selective scan: u, dt (B, S, C); bmat, cmat (B, S, N); a (C,
    N); h0 (B, C, N). Returns (y (B, S, C), the final h)."""
    s = u.shape[1]
    chunk = min(SCAN_CHUNK, s)
    if s % chunk:
        chunk = s
    remat = remat and torch.is_grad_enabled()
    h, ys = h0, []
    for lo in range(0, s, chunk):
        args = (h, u[:, lo:lo + chunk], dt[:, lo:lo + chunk],
                bmat[:, lo:lo + chunk], cmat[:, lo:lo + chunk], a)
        y, h = (checkpoint(_chunk, *args, use_reentrant=False) if remat
                else _chunk(*args))
        ys.append(y)
    return torch.cat(ys, 1) + u * d_skip, h


def state_dtype(dtype) -> torch.dtype:
    """The dtype of the projections past the conv and of the scan: fp32,
    as the reference's, for an fp32 or bf16 model; fp64 for fp64 inputs
    (the same function in fp64, what an fp32 run's error is measured
    against)."""
    return torch.promote_types(dtype, torch.float32)


def _proj(p: dict, u: torch.Tensor, cfg, pal=None):
    """dt (through softplus), bmat, cmat of the conv's output u, in the
    state dtype (x_proj's partial product summed over the model group)."""
    ds = cfg.ssm.d_state
    dtr = mamba_dims(cfg)[1]
    dbc = psum_model((u @ p["x_proj"].to(u.dtype)).to(state_dtype(u.dtype)),
                     pal)
    dt_low, bmat, cmat = (dbc[..., :dtr], dbc[..., dtr:dtr + ds],
                          dbc[..., dtr + ds:])
    return softplus(dt_low @ p["dt_proj"] + p["dt_bias"]), bmat, cmat


def mamba_fwd(p: dict, x: torch.Tensor, cfg, cache: dict = None,
              pal=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d). With ``cache`` (one layer's views of a
    decode cache) the conv ring (the last d_conv - 1 inputs before the
    conv) and the final h are written into it. Under tensor parallelism
    this rank's channels, the output summed over the model group; with
    ``pal.sp`` x and the output are this rank's sequence chunk."""
    x = seq_gathered(x, pal)
    b, s, _ = x.shape
    sd = state_dtype(x.dtype)
    u_pre = x @ p["in_x"].to(x.dtype)
    z = x @ p["in_z"].to(x.dtype)
    u = F.silu(conv1d(u_pre, p["conv_w"].to(u_pre.dtype), p["conv_b"]))
    dt, bmat, cmat = _proj(p, u, cfg, pal)
    a = torch.exp(p["A_log"]).to(sd)
    h0 = torch.zeros((b, *p["A_log"].shape), dtype=sd, device=x.device)
    y, h = ssm_scan_chunked(u.to(sd), dt, bmat, cmat, a, p["D"].to(sd), h0,
                            remat=cfg.remat)
    if cache is not None:
        take = min(cfg.ssm.d_conv - 1, s)
        cache["conv"].zero_()
        cache["conv"][:, cache["conv"].shape[1] - take:] = u_pre[:, s - take:]
        cache["h"].copy_(h)
    y = y.to(x.dtype) * F.silu(z)
    return row_parallel_out(y @ p["out_proj"].to(y.dtype), pal)


def init_mamba_cache(cfg, batch: int, dtype, *, lead=(), device=None,
                     pal=None) -> dict:
    """Zero conv ring and h of this rank's channels."""
    di = local_dims(cfg, pal)[0]
    return {"conv": torch.zeros((*lead, batch, cfg.ssm.d_conv - 1, di),
                                dtype=dtype, device=device),
            "h": torch.zeros((*lead, batch, di, cfg.ssm.d_state),
                             device=device)}


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg,
                 pal=None) -> torch.Tensor:
    """One token x (B, 1, d) -> (B, 1, d), O(1) in the context; the conv
    ring and h in ``cache`` are updated in place (this rank's channels,
    the output summed over the model group)."""
    u = x[:, 0] @ p["in_x"].to(x.dtype)
    z = x[:, 0] @ p["in_z"].to(x.dtype)
    win = torch.cat([cache["conv"], u[:, None]], 1)          # (B, dc, C)
    u = F.silu((win * p["conv_w"].to(win.dtype)).sum(1)
               + p["conv_b"].to(win.dtype))
    dt, bmat, cmat = _proj(p, u, cfg, pal)
    da = torch.exp(dt[..., None] * (-torch.exp(p["A_log"])))
    h = da * cache["h"] + (dt * u.float())[..., None] * bmat[:, None, :]
    y = (h @ cmat[..., None])[..., 0] + u.float() * p["D"]
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(h)
    y = y.to(x.dtype) * F.silu(z)
    return psum_model((y @ p["out_proj"].to(y.dtype))[:, None], pal)
