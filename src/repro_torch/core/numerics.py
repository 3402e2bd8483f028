"""Shared numeric conventions (the port's copy of ``repro.core.numerics``).

Besides ``safe_denom`` this module holds ``tanh_f32``, the one tanh the
port uses wherever the reference's selection depends on a tanh. REGTOP-k
ranks support entries by ``|a * tanh(|1 + delta| / mu)|``, so a tanh that
differs by one ulp between two runs can flip a selection at the k-th key.
``torch.tanh`` differs from XLA's CPU tanh by up to 5 ulp and between the
CPU and CUDA builds of torch. ``tanh_f32`` instead spells out XLA's own
f32 approximation (the clamped 13/6 rational polynomial with fused
multiply-adds) in elementwise ops that round correctly on every device,
so it gives the same bits on the CPU and on the card, and the same bits
as the reference's compiled program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

TINY = 1e-12

# XLA's f32 tanh approximation (EmitFastTanh, FMA variant): inputs are
# clamped to +-_TANH_CLAMP, where the rational form reaches exactly 1.0,
# and |x| < _TANH_SMALL returns x itself.
_TANH_CLAMP = 7.99881172180175781
_TANH_SMALL = float(np.float32(0.0004))
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13,
             -8.60467152213735e-11, 5.12229709037114e-08,
             1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04,
             2.26843463243900e-03, 4.89352518554385e-03)


def f32(x: float) -> float:
    """Round a Python float to the nearest fp32 value."""
    return float(np.float32(x))


_FMA_CHUNK = 1 << 24     # elements a chunk of fma_f32 (fp64 temporaries)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """round_f32(a * b + c) with one rounding, as a fused multiply-add
    computes it, for fp32 tensors a and c of one shape and b an fp32
    scalar (a Python float, rounded to fp32 first, or a 0-d tensor).

    The compiled reference contracts a multiply feeding an add into an
    FMA (XLA's CPU backend does, for DGC's momentum and the optimizers'
    updates), and PyTorch has no fp32 FMA that is correctly rounded on
    every device. The product is exact in fp64; TwoSum gives the fp64
    sum and its exact error, which round the sum to odd; rounding that
    to fp32 is then the correctly rounded result (53 >= 24 + 2 bits).
    Works in chunks, so the fp64 temporaries stay small at any length."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(f32(b))
    b = b.to(a.device, torch.float64)
    out = torch.empty_like(a)
    flat, cflat, oflat = a.reshape(-1), c.reshape(-1), out.view(-1)
    for lo in range(0, flat.numel(), _FMA_CHUNK):
        hi = lo + _FMA_CHUNK
        oflat[lo:hi] = _fma_odd(flat[lo:hi].double() * b,
                                cflat[lo:hi].double())
    return out


def _fma_odd(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 of p + c for fp64 p, c, through the sum rounded to odd."""
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)      # TwoSum: s + err == p + c
    inexact = (err != 0) & torch.isfinite(err)
    # round to odd: truncate toward zero, then set the last bit
    toward_zero = inexact & ((err < 0) != (s < 0))
    bits = s.view(torch.int64) - toward_zero.long()
    return (bits | inexact.long()).view(torch.float64).float()


def bf16(x: float) -> float:
    """The Python scalar x rounded to the nearest bf16 (ties to even), as
    the reference's weak-typed constants round next to a bf16 operand."""
    x = float(x)
    if x == 0.0 or not math.isfinite(x):
        return x
    m, e = math.frexp(x)                 # |m| in [0.5, 1): 8 bits of it
    return math.ldexp(round(m * 256), e - 8)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to bf16 and widened back: one bf16 operation of the
    reference's compiled program, which computes each in fp32 and rounds
    its result."""
    return x.to(torch.bfloat16).float()


def safe_denom(denom: torch.Tensor, tiny: float = TINY) -> torch.Tensor:
    """Zero-safe divisor: |denom| <= tiny is replaced by
    sign(denom)*tiny + tiny (positive for denom >= 0, the REGTOP-k
    Algorithm 1 line 5 convention)."""
    return torch.where(denom.abs() > tiny, denom,
                       torch.sign(denom) * tiny + tiny)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """round_f32(a * b + c) for fp32 a, b: the product is exact in fp64
    and the sum is rounded once to fp64, then to fp32 (a double rounding
    that differs from a true fused multiply-add only when the fp64 sum
    lands exactly on an fp32 midpoint)."""
    return (a.double() * b.double() + f32(c)).float()


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 tanh, bit for bit (see the module docstring)."""
    x = x.float()
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    num = torch.full_like(x2, f32(_TANH_NUM[0]))
    for coef in _TANH_NUM[1:]:
        num = _fma_f32(x2, num, coef)
    num = xc * num
    den = torch.full_like(x2, f32(_TANH_DEN[0]))
    for coef in _TANH_DEN[1:]:
        den = _fma_f32(x2, den, coef)
    return torch.where(x.abs() < _TANH_SMALL, x, num / den)


# XLA's CPU backend rewrites a reduction longer than this into windows of
# this many elements (TreeReductionRewriter)
XLA_REDUCE_WINDOW = 32


def xla_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """0-d fp32 sum of a 1-D fp32 tensor in the order the compiled
    reference's CPU program adds it: XLA cuts a reduction of more than 32
    elements into windows of 32 (the vector zero-padded to a multiple of
    32, half of the padding in front and the rest behind), adds each
    window in order from 0.0, and repeats on the window sums until 32 or
    fewer are left, which it adds in order from 0.0. No fused
    multiply-add: a product feeding the sum is rounded first. Elementwise
    adds only, so the bits are the same on every device."""
    x = x.reshape(-1).float()
    w = XLA_REDUCE_WINDOW
    while x.numel() > w:
        n = x.numel()
        pad = -(-n // w) * w - n
        x = _sum_in_order(torch.nn.functional.pad(
            x, (pad // 2, pad - pad // 2)).view(-1, w))
    return _sum_in_order(x.view(1, -1)).reshape(())


NORM_CHUNK = 1 << 24


def norm_f32(x: torch.Tensor) -> torch.Tensor:
    """0-d fp32 2-norm of x, the compiled reference's ``jnp.linalg.norm``:
    the square root of the sum of the fp32 squares, each chunk of
    NORM_CHUNK elements one ``torch.sum`` (pairwise on the CPU, a tree on
    the card; within an ulp or two of XLA's windowed sum), the chunks
    added in order. Not ``torch.linalg.vector_norm``, whose fp32 CPU
    reduction drifts 4e-5 relative at a million elements."""
    x = x.reshape(-1).float()
    return torch.sqrt(sum(torch.sum(c * c) for c in x.split(NORM_CHUNK)))


def _sum_in_order(v: torch.Tensor) -> torch.Tensor:
    """Row sums of a 2-D tensor, each added column by column from 0.0."""
    acc = torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)
    for c in range(v.shape[1]):
        acc = acc + v[:, c]
    return acc


def recip_f32(x: float) -> float:
    """fp32 1/x. A compiled reference program divides by a constant mu
    as a multiply by this reciprocal (XLA's algebraic simplifier)."""
    return f32(np.float32(1.0) / np.float32(x))


def safe_denom_bf16(d: torch.Tensor) -> torch.Tensor:
    """:func:`safe_denom` of bf16 values (fp32 holding them) as the
    compiled reference computes it in bf16: the tiny constant rounded to
    bf16, each operation of sign(d) * tiny + tiny rounded."""
    tiny = bf16(TINY)
    alt = round_bf16(round_bf16(torch.sign(d) * tiny) + tiny)
    return torch.where(d.abs() > tiny, d, alt)


def regularizer_bf16(delta: torch.Tensor, mu: float) -> torch.Tensor:
    """REGTOP-k's tanh(|1 + delta| / mu) on bf16 values as the compiled
    reference computes it under a bf16 state: the add rounded, the
    division by mu a multiply by the fp32 reciprocal of bf16(mu),
    rounded, XLA's fp32 tanh rounded."""
    w = round_bf16(round_bf16(delta + 1.0).abs() * recip_f32(bf16(mu)))
    return round_bf16(tanh_f32(w))


def regularizer_factor(Q: float, mu: float) -> float:
    """REGTOP-k's off-support score factor tanh(|1 + Q| / mu) as the
    reference's compiled program produces it: the expression is a
    compile-time constant there, folded with the host's tanh in double
    precision and rounded to fp32. Computed on the host here too, so it
    never costs a device read."""
    base = abs(f32(f32(1.0) + f32(Q)))
    return f32(math.tanh(f32(base * recip_f32(mu))))
