"""The compression kernels for Hopper and their plain PyTorch versions
(the port of ``repro.kernels.compress.kernel``).

Sweep 1 (:func:`sweep1`, kernel ``csrc/sweep1.cu``) reads g and the error
state once and emits ``a = err + g``, ``score = a * c``, the per-tile amax
of |score| and a 2048-bin histogram of the fp32 bit pattern of |score|.
Sweep 2 (:func:`sweep2`, kernel ``csrc/sweep2.cu``) compacts the
``|score| >= tau`` candidates of every 4096-element tile into that tile's
static ``MAXPB`` slots. The CountSketch encodes (kernels in
``csrc/sketch.cu``): :func:`sweep1_sketch` emits ``a = err + g`` and the
(rows, width) CountSketch of a in one pass, :func:`sketch_encode` the
sketch of a given a.

Each wrapper checks its inputs and dispatches on the tensors' device: a
CPU tensor runs the plain version, a CUDA tensor launches the kernel (or
raises). There is no fallback from one to the other. ``launches`` on each
wrapper counts kernel launches, so a run can show that its main path went
through the kernels.

Unlike the reference's Pallas launchers, both kernels take any J and
mask the ragged last tile themselves: the caller pads nothing, the
histogram needs no bin-0 correction, and ragged-tail lanes never flag.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sketch as csk
from repro_torch.core.bigvec import INVALID_IDX, to_u32_bits
from repro_torch.core.select import hist_tail_bin
from repro_torch.kernels.common import (aligned as _aligned,
                                        check_launch as _check_launch,
                                        check_vec as _check_vec,
                                        grid as _grid, lib as _lib,
                                        on_card as _on_card,
                                        stream as _stream)

BLOCK = 4096             # elements per tile (the reference's grid step)
BINS = 2048              # 2^11 bit-pattern bins: exponent + 3 mantissa bits
_BIN_SHIFT = 20          # fp32 bits >> 20 -> [0, 2047] for non-negative floats
_PLAIN_ROWS = 1 << 14    # tiles per chunk in the plain versions (bounds memory)


def bit_bin(absx: torch.Tensor) -> torch.Tensor:
    """Histogram bin of a non-negative fp32 value: the top 11 bits of its
    IEEE-754 encoding. Monotone in the value."""
    return absx.float().contiguous().view(torch.int32) >> _BIN_SHIFT


def bin_lower_edge(b: torch.Tensor) -> torch.Tensor:
    """Smallest fp32 value mapping to bin b."""
    return (b.to(torch.int32) << _BIN_SHIFT).view(torch.float32)


def key_bin_edge(x: torch.Tensor) -> torch.Tensor:
    """Lower edge of x's bit-pattern bin."""
    return bin_lower_edge(bit_bin(x.reshape(-1))).reshape(x.shape)


def threshold_from_hist(hist: torch.Tensor, target) -> torch.Tensor:
    """Lower edge of the largest bin whose tail count >= target, as a
    (1,) fp32 tensor on hist's device (0.0 when target exceeds the
    histogram mass, which routes the caller to the exact fallback)."""
    b = hist_tail_bin(hist, target)
    edge = bin_lower_edge(b.clamp(min=0).reshape(1))
    return torch.where(b >= 0, edge, torch.zeros_like(edge))


def rows_of(j: int) -> int:
    return -(-j // BLOCK)


# ---------------------------------------------------------------------------
# Plain versions (CPU path; held against the kernels on the card)
# ---------------------------------------------------------------------------

def sweep1_plain(g, err_prev, c):
    a = err_prev + g
    score = a * c
    j = a.numel()
    rows = rows_of(j)
    amax = torch.empty(rows, dtype=torch.float32, device=a.device)
    hist = torch.zeros(BINS, dtype=torch.int64, device=a.device)
    for r0 in range(0, rows, _PLAIN_ROWS):
        lo, hi = r0 * BLOCK, min(j, (r0 + _PLAIN_ROWS) * BLOCK)
        keys = score[lo:hi].abs()
        hist += torch.bincount(bit_bin(keys).long(), minlength=BINS)
        full = (hi - lo) // BLOCK
        amax[r0:r0 + full] = keys[:full * BLOCK].view(full, BLOCK).amax(1)
        if (hi - lo) % BLOCK:
            amax[r0 + full] = keys[full * BLOCK:].amax()
    return a, score, amax, hist.to(torch.int32)


def sweep2_plain(score, tau, maxpb: int):
    j = score.numel()
    rows = rows_of(j)
    dev = score.device
    vals = torch.full((rows * maxpb,), float("-inf"), device=dev)
    idx = torch.full((rows * maxpb,), -1, dtype=torch.int32, device=dev)
    cnt = torch.empty(rows, dtype=torch.int32, device=dev)
    for r0 in range(0, rows, _PLAIN_ROWS):
        lo, hi = r0 * BLOCK, min(j, (r0 + _PLAIN_ROWS) * BLOCK)
        nr = rows_of(hi - lo)
        keys = torch.zeros(nr * BLOCK, device=dev)
        keys[:hi - lo] = score[lo:hi].abs()
        flags = torch.zeros(nr * BLOCK, dtype=torch.bool, device=dev)
        flags[:hi - lo] = keys[:hi - lo] >= tau     # ragged lanes never flag
        flags, keys = flags.view(nr, BLOCK), keys.view(nr, BLOCK)
        pos = torch.cumsum(flags, 1, dtype=torch.int64) - 1
        cnt[r0:r0 + nr] = flags.sum(1, dtype=torch.int32)
        rr, ll = torch.nonzero(flags & (pos < maxpb), as_tuple=True)
        slot = (r0 + rr) * maxpb + pos[rr, ll]
        vals[slot] = keys[rr, ll]
        idx[slot] = to_u32_bits((r0 + rr) * BLOCK + ll)
    return vals, idx, cnt


def sketch_encode_plain(a, rows: int, width: int):
    """CountSketch (rows, width) of a (J,): per row, in element order,
    sk[r, h_r(i)] += s_r(i) * a_i. On the CPU ``index_add_`` adds in
    index order, which is the reference's sequential sum bit for bit."""
    j = a.numel()
    sk = torch.zeros((rows, width), dtype=torch.float32, device=a.device)
    step = _PLAIN_ROWS * BLOCK
    for lo in range(0, j, step):
        hi = min(j, lo + step)
        chunk = a[lo:hi]
        idx = torch.arange(lo, hi, dtype=torch.int64, device=a.device)
        for r in range(rows):
            h, pos = csk.row_hash(r, width, idx)
            sk[r].index_add_(0, h, torch.where(pos, chunk, -chunk))
    return sk


def sweep1_sketch_plain(g, err_prev, rows: int, width: int):
    a = err_prev + g
    return a, sketch_encode_plain(a, rows, width)


def sketch_error_bound(a, rows: int, width: int):
    """Per-bucket bound (rows, width) on |sketch - sketch_plain| when the
    kernel's float atomics add a bucket's contributions in another order
    than the plain version. Any order of summing n_b terms lies within
    (n_b - 1) * 2^-24 * sum|contrib| of the exact sum, so two orders lie
    within twice that of each other; 4 * n_b * 2^-24 * sum|contrib|
    keeps a factor of two in hand."""
    j = a.numel()
    count = torch.zeros((rows, width), dtype=torch.float64, device=a.device)
    mass = torch.zeros((rows, width), dtype=torch.float64, device=a.device)
    step = _PLAIN_ROWS * BLOCK
    for lo in range(0, j, step):
        hi = min(j, lo + step)
        mag = a[lo:hi].double().abs()
        idx = torch.arange(lo, hi, dtype=torch.int64, device=a.device)
        for r in range(rows):
            h, _ = csk.row_hash(r, width, idx)
            count[r].index_add_(0, h, torch.ones_like(mag))
            mass[r].index_add_(0, h, mag)
    return 4.0 * count * 2.0 ** -24 * mass


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def sweep1(g: torch.Tensor, err_prev: torch.Tensor, c: torch.Tensor):
    """(a, score, amax (rows,), hist (2048,) int32) for g, err_prev (J,)
    fp32 and c (1,) fp32, all on one device."""
    j = g.numel()
    _check_vec("g", g)
    _check_vec("err_prev", err_prev, j)
    _check_vec("c", c, 1)
    if len({g.device, err_prev.device, c.device}) != 1:
        raise ValueError("sweep1: g, err_prev and c must share a device")
    if not _on_card(g):
        return sweep1_plain(g, err_prev, c)
    rows = rows_of(j)
    a = torch.empty_like(g)
    score = torch.empty_like(g)
    amax = torch.empty(rows, dtype=torch.float32, device=g.device)
    hist = torch.zeros(BINS, dtype=torch.int32, device=g.device)
    fn = _lib("sweep1").sweep1_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    err = fn(g.data_ptr(), err_prev.data_ptr(), c.data_ptr(), a.data_ptr(),
             score.data_ptr(), amax.data_ptr(), hist.data_ptr(), j,
             _grid(g.device, rows), _aligned(g, err_prev, a, score),
             _stream(g.device))
    _check_launch("sweep1", err)
    sweep1.launches += 1
    return a, score, amax, hist


def sweep2(score: torch.Tensor, tau: torch.Tensor, maxpb: int):
    """(vals (rows*maxpb,) fp32, idx (rows*maxpb,) int32 holding uint32
    bits, cnt (rows,) int32) for score (J,) fp32 and tau (1,) fp32."""
    j = score.numel()
    _check_vec("score", score)
    _check_vec("tau", tau, 1)
    if score.device != tau.device:
        raise ValueError("sweep2: score and tau must share a device")
    if j >= INVALID_IDX:
        raise ValueError(f"sweep2: J={j} needs indices beyond uint32")
    if not 1 <= maxpb <= BLOCK:
        raise ValueError(f"sweep2: maxpb={maxpb} outside [1, {BLOCK}]")
    if not _on_card(score):
        return sweep2_plain(score, tau, maxpb)
    rows = rows_of(j)
    vals = torch.empty(rows * maxpb, dtype=torch.float32, device=score.device)
    idx = torch.empty(rows * maxpb, dtype=torch.int32, device=score.device)
    cnt = torch.empty(rows, dtype=torch.int32, device=score.device)
    fn = _lib("sweep2").sweep2_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    err = fn(score.data_ptr(), tau.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), cnt.data_ptr(), j, maxpb, _aligned(score),
             _stream(score.device))
    _check_launch("sweep2", err)
    sweep2.launches += 1
    return vals, idx, cnt


def _hash_args(rows: int):
    """The rows' hash constants as host uint32 arrays; the launcher copies
    them into the kernel's by-value argument."""
    u32s = ctypes.c_uint * rows
    return u32s(*csk.MULTS[:rows]), u32s(*csk.ADDS[:rows])


def sweep1_sketch(g: torch.Tensor, err_prev: torch.Tensor, rows: int,
                  width: int):
    """(a (J,) fp32, CountSketch of a (rows, width) fp32) for g, err_prev
    (J,) fp32 on one device; a = err_prev + g."""
    j = g.numel()
    _check_vec("g", g)
    _check_vec("err_prev", err_prev, j)
    if g.device != err_prev.device:
        raise ValueError("sweep1_sketch: g and err_prev must share a device")
    csk.check_shape(j, rows, width)
    if not _on_card(g):
        return sweep1_sketch_plain(g, err_prev, rows, width)
    a = torch.empty_like(g)
    sk = torch.zeros((rows, width), dtype=torch.float32, device=g.device)
    fn = _lib("sketch").sweep1_sketch_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    mults, adds = _hash_args(rows)
    err = fn(g.data_ptr(), err_prev.data_ptr(), a.data_ptr(), sk.data_ptr(),
             mults, adds, rows, width, j, _grid(g.device, rows_of(j)),
             _aligned(g, err_prev, a), _stream(g.device))
    _check_launch("sweep1_sketch", err)
    sweep1_sketch.launches += 1
    return a, sk


def sketch_encode(a: torch.Tensor, rows: int, width: int):
    """CountSketch (rows, width) fp32 of a (J,) fp32."""
    j = a.numel()
    _check_vec("a", a)
    csk.check_shape(j, rows, width)
    if not _on_card(a):
        return sketch_encode_plain(a, rows, width)
    sk = torch.zeros((rows, width), dtype=torch.float32, device=a.device)
    fn = _lib("sketch").sketch_encode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    mults, adds = _hash_args(rows)
    err = fn(a.data_ptr(), sk.data_ptr(), mults, adds, rows, width, j,
             _grid(a.device, rows_of(j)), _aligned(a), _stream(a.device))
    _check_launch("sketch_encode", err)
    sketch_encode.launches += 1
    return sk


sweep1.launches = 0
sweep2.launches = 0
sweep1_sketch.launches = 0
sketch_encode.launches = 0
KERNELS = (sweep1, sweep2, sweep1_sketch, sketch_encode)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
