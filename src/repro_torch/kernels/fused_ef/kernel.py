"""The dense reference-layout REGTOP-k passes for Hopper and their plain
PyTorch versions (the port of ``repro.kernels.fused_ef.kernel``).

:func:`scores` (kernel ``csrc/fused_ef.cu``, ``scores_launch``) reads g,
the error state and the dense posterior (a_prev, g_agg, s_prev) once and
writes ``a = err + g`` and the REGTOP-k score
``a * tanh(|1 + delta| / mu)``; :func:`apply` (``apply_launch``) writes
``ghat = mask * a`` and ``err' = a - ghat``.

Each wrapper checks its inputs and dispatches on the tensors' device: a
CPU tensor runs the plain version, a CUDA tensor launches the kernel (or
raises). ``launches`` on each wrapper counts kernel launches. Any J is
served: the kernels mask the ragged tail themselves, so nothing is
padded. The plain versions work in chunks of J, so they run at full J on
the card without a dozen J-sized temporaries.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.numerics import (f32, fma_f32, recip_f32, safe_denom,
                                       tanh_f32)
from repro_torch.kernels.common import (aligned, check_launch, check_vec,
                                        grid, lib, on_card, same_device,
                                        stream)

THREADS = 256            # threads per CTA; a CTA takes 4 * THREADS per pass
_PLAIN_CHUNK = 1 << 24   # elements per chunk of the plain versions


def _chunks(j: int):
    for lo in range(0, j, _PLAIN_CHUNK):
        yield lo, min(j, lo + _PLAIN_CHUNK)


def scores_plain(g, err, a_prev, g_agg, s_prev, *, omega: float, mu: float,
                 Q: float):
    """(a, score), each operation one fp32 rounding as the reference's
    compiled program computes it (``/ mu`` as ``* f32(1/mu)``)."""
    a = torch.empty_like(g)
    score = torch.empty_like(g)
    for lo, hi in _chunks(g.numel()):
        ac = err[lo:hi] + g[lo:hi]
        # g_agg - omega * a_prev: one fused multiply-add, as compiled
        sent = (fma_f32(a_prev[lo:hi], -omega, g_agg[lo:hi])
                / safe_denom(omega * ac))
        sp = s_prev[lo:hi]
        delta = sp * sent + Q * (1.0 - sp)
        reg = tanh_f32((1.0 + delta).abs() * recip_f32(mu))
        a[lo:hi] = ac
        score[lo:hi] = ac * reg
    return a, score


def apply_plain(a, mask):
    """(ghat, err') = (mask * a, a - mask * a)."""
    ghat = torch.empty_like(a)
    err = torch.empty_like(a)
    for lo, hi in _chunks(a.numel()):
        ghat[lo:hi] = mask[lo:hi] * a[lo:hi]
        err[lo:hi] = a[lo:hi] - ghat[lo:hi]
    return ghat, err


def _grid(x: torch.Tensor) -> int:
    return grid(x.device, -(-x.numel() // (4 * THREADS)))


def scores(g, err, a_prev, g_agg, s_prev, *, omega: float, mu: float,
           Q: float):
    """(a, score) for five (J,) fp32 tensors on one device; omega, mu and
    Q are passed to the kernel as the fp32 values the compiled reference
    uses (omega, 1/mu, Q)."""
    j = g.numel()
    ins = (g, err, a_prev, g_agg, s_prev)
    for name, x in zip(("g", "err", "a_prev", "g_agg", "s_prev"), ins):
        check_vec(name, x, j)
    same_device("scores", *ins)
    if not on_card(g):
        return scores_plain(*ins, omega=omega, mu=mu, Q=Q)
    a = torch.empty_like(g)
    score = torch.empty_like(g)
    fn = lib("fused_ef").scores_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    check_launch("scores", fn(
        *(x.data_ptr() for x in ins), a.data_ptr(), score.data_ptr(), j,
        f32(omega), recip_f32(mu), f32(Q), _grid(g),
        aligned(*ins, a, score), stream(g.device)))
    scores.launches += 1
    return a, score


def apply(a, mask):
    """(ghat, err') for a and a 0/1 mask, (J,) fp32 on one device."""
    j = a.numel()
    check_vec("a", a)
    check_vec("mask", mask, j)
    same_device("apply", a, mask)
    if not on_card(a):
        return apply_plain(a, mask)
    ghat = torch.empty_like(a)
    err = torch.empty_like(a)
    fn = lib("fused_ef").apply_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    check_launch("apply", fn(a.data_ptr(), mask.data_ptr(), ghat.data_ptr(),
                             err.data_ptr(), j, _grid(a),
                             aligned(a, mask, ghat, err), stream(a.device)))
    apply.launches += 1
    return ghat, err


scores.launches = 0
apply.launches = 0
KERNELS = (scores, apply)
