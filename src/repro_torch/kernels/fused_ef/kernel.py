"""The dense reference-layout REGTOP-k passes for Hopper and their plain
PyTorch versions (the port of ``repro.kernels.fused_ef.kernel``).

:func:`scores` (kernel ``csrc/fused_ef.cu``, ``scores_launch``) reads g,
the error state and the dense posterior (a_prev, g_agg, s_prev) once and
writes ``a = err + g`` and the REGTOP-k score
``a * tanh(|1 + delta| / mu)``; :func:`scores_bf16` (``scores_bf16_launch``)
is its read of a bf16 state, every operation rounded to bf16 as the
reference's compiled program rounds it; :func:`apply` (``apply_launch``) writes
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

from repro_torch.core.numerics import (bf16, f32, fma_f32, recip_f32,
                                       regularizer_bf16, round_bf16,
                                       safe_denom, safe_denom_bf16, tanh_f32)
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


def bf16_scalars(omega: float, mu: float, Q: float) -> tuple:
    """(omega, 1/mu, Q) as the compiled reference uses them on a bf16
    state: omega and Q rounded to bf16, the fp32 reciprocal of bf16(mu)."""
    return bf16(omega), recip_f32(bf16(mu)), bf16(Q)


def scores_bf16_plain(g, err, a_prev, g_agg, s_prev, *, omega: float,
                      mu: float, Q: float):
    """(a bf16, score fp32) of :func:`scores_bf16`: g fp32, the four
    state vectors bf16; every operation rounded to bf16."""
    om, _, q = bf16_scalars(omega, mu, Q)
    a = torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
    score = torch.empty_like(g)
    for lo, hi in _chunks(g.numel()):
        ac = round_bf16(err[lo:hi].float() + round_bf16(g[lo:hi]))
        safe = safe_denom_bf16(round_bf16(om * ac))
        num = round_bf16(g_agg[lo:hi].float()
                         - round_bf16(om * a_prev[lo:hi].float()))
        sent = round_bf16(num / safe)
        sp = s_prev[lo:hi].float()
        delta = round_bf16(round_bf16(sp * sent)
                           + round_bf16(round_bf16(1.0 - sp) * q))
        a[lo:hi] = ac
        score[lo:hi] = round_bf16(ac * regularizer_bf16(delta, mu))
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


def scores_bf16(g, err, a_prev, g_agg, s_prev, *, omega: float, mu: float,
                Q: float):
    """(a (J,) bf16, score (J,) fp32) for g (J,) fp32 and err, a_prev,
    g_agg, s_prev (J,) bf16 on one device: the bf16 read of
    :func:`scores`, each operation rounded to bf16 (the score holds bf16
    values). Its own ``launches`` count."""
    j = g.numel()
    check_vec("g", g, j)
    ins = (g, err, a_prev, g_agg, s_prev)
    for name, x in zip(("err", "a_prev", "g_agg", "s_prev"), ins[1:]):
        check_vec(name, x, j, torch.bfloat16)
    same_device("scores_bf16", *ins)
    if not on_card(g):
        return scores_bf16_plain(*ins, omega=omega, mu=mu, Q=Q)
    a = torch.empty(j, dtype=torch.bfloat16, device=g.device)
    score = torch.empty_like(g)
    om, rmu, q = bf16_scalars(omega, mu, Q)
    fn = lib("fused_ef").scores_bf16_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    vec = int(all(x.data_ptr() % (4 * x.element_size()) == 0
                  for x in ins + (a, score)))
    check_launch("scores_bf16", fn(
        *(x.data_ptr() for x in ins), a.data_ptr(), score.data_ptr(), j,
        om, rmu, q, _grid(g), vec, stream(g.device)))
    scores_bf16.launches += 1
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


KERNELS = (scores, scores_bf16, apply)
for _fn in KERNELS:
    _fn.launches = 0
# Byte contracts at length j, each input read once and each output written
# once: the score reads g, err, a_prev, g_agg and s_prev and writes a and
# the score (fp32; its bf16 read: g in fp32 and four bf16 vectors, a in
# bf16, the score fp32); the apply reads a and the mask and writes ghat
# and err.
scores.bytes_moved = lambda j: 28 * j
scores_bf16.bytes_moved = lambda j: 18 * j
apply.bytes_moved = lambda j: 16 * j
