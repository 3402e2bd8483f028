"""The compression kernels for Hopper and their plain PyTorch versions
(the port of ``repro.kernels.compress.kernel``).

Sweep 1 (:func:`sweep1`, kernel ``csrc/sweep1.cu``) reads g and the error
state once and emits ``a = err + g``, ``score = a * c``, the per-tile amax
of |score| and a 2048-bin histogram of the fp32 bit pattern of |score|;
its dgc mode (:func:`sweep1_dgc`, the same kernel) also reads the
momentum and emits ``mom' = momentum * mom + g`` with ``a = err + mom'``;
its gated variant (:func:`sweep1_gated`, both modes) masks the inputs by
a worker's participation bit and decays a sitting-out worker's error.
Each mode also reads a bf16 error state (and momentum) as the reference's
``ef_dtype="bfloat16"`` stores it (:func:`sweep1_bf16`,
:func:`sweep1_dgc_bf16`, :func:`sweep1_gated_bf16`): widened in registers,
with g rounded to bf16 first, the outputs fp32. The per-bucket launches
of the bucketed pipeline write into views of the caller's (J,) outputs
(``out=``).
Sweep 2 (:func:`sweep2`, kernel ``csrc/sweep2.cu``) compacts the
``|score| >= tau`` candidates of every 4096-element tile into that tile's
static ``MAXPB`` slots. The CountSketch encodes share the kernels of
``csrc/sketch_parts.cu``, privatised bucket ranges in two passes per
chunk of J: :func:`sweep1_sketch` emits ``a = err + g`` and the (rows,
width) CountSketch of a, :func:`sketch_encode` the sketch of a given a.
The fused encode also reads a bf16 error state (:func:`sweep1_sketch_bf16`)
and masks its inputs by a participation bit and the error decay
(:func:`sweep1_sketch_gated`, :func:`sweep1_sketch_gated_bf16`), as the
reference's ``masked_inputs`` feeds its kernel.
The partitioned encode's index arithmetic has plain versions here
(:func:`fastmod`, :func:`sketch_starts_plain`,
:func:`sketch_encode_parts_plain`), which the CPU tests hold against the
plain encode.

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

import numpy as np
import torch

from repro_torch.core import sketch as csk
from repro_torch.core.bigvec import INVALID_IDX, to_u32_bits
from repro_torch.core.numerics import f32, fma_f32
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
# the partitioned CountSketch encode (sweep1_sketch on the card)
PART_SHIFT = 14          # R = 2^14 buckets a partition: 64 KB of fp32 sums
HASH_BUCKETS = 1 << 24   # a bucket is (hash >> 8) % width: below 2^24, so a
                         # wider row's later buckets stay 0 and get no
                         # partition (at most 1024 partitions a row)
SKETCH_TILE = 8192       # elements a pass-1 tile (512 threads x 16)
CHUNK_PAIRS = 3 << 27    # pairs a chunk: 2.4 GB of pair buffer at 6 B a pair
_U64 = (1 << 64) - 1


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


def merge_bucket_hists(hists) -> torch.Tensor:
    """The whole vector's histogram from its buckets' (the bin of an
    element depends on its value only), summed in bucket order."""
    merged = hists[0]
    for h in hists[1:]:
        merged = merged + h
    return merged


def threshold_from_bucket_hists(hists, target) -> torch.Tensor:
    """The global tau of a bucketed sweep: :func:`threshold_from_hist` of
    the merged histogram, the flat sweep's tau for any bucketing."""
    return threshold_from_hist(merge_bucket_hists(hists), target)


def rows_of(j: int) -> int:
    return -(-j // BLOCK)


# ---------------------------------------------------------------------------
# Plain versions (CPU path; held against the kernels on the card)
# ---------------------------------------------------------------------------

def masked_inputs(g, err_prev, participate, err_decay: float):
    """(g_eff, err_eff) = (where(p, g, 0), where(p, err_prev, err_decay *
    err_prev)) for the 0-d participation bit p (the reference's
    ``masked_inputs``, which its reference pipeline and the gated sweep
    share): a sitting-out worker contributes nothing and its error
    decays. The decay multiplies in fp32 and rounds back to the error's
    dtype (bf16 state: one rounding to bf16)."""
    p = participate.reshape(())
    decayed = (f32(err_decay) * err_prev.float()).to(err_prev.dtype)
    return (torch.where(p, g, torch.zeros((), dtype=g.dtype,
                                          device=g.device)),
            torch.where(p, err_prev, decayed))


def sweep1_plain(g, err_prev, c, mom=None, momentum: float = 0.0,
                 gate=None, decay: float = 1.0):
    """Plain version of :func:`sweep1`; with ``mom`` the dgc mode, which
    returns mom' after (a, score, amax, hist). mom' is one fused
    multiply-add, as the kernel and the compiled reference round it.
    With ``gate`` ((1,) fp32, the participation bit p = gate > 0.5) the
    gated variant (:func:`sweep1_gated`): the reference's masked inputs
    g_eff = where(p, g, 0), err_eff = where(p, err, decay * err), then
    a = err_eff + g_eff, or in dgc mode a = err_eff + where(p, mom', 0)
    with mom' = momentum * mom + g_eff. A bf16 ``err_prev`` (and ``mom``)
    is the bf16 read: g is rounded to bf16 first, the decayed error back
    to bf16, and both states widen to fp32."""
    if err_prev.dtype == torch.bfloat16:
        g = g.to(torch.bfloat16)
    if gate is not None:
        p = gate.reshape(()) > 0.5
        g, err_prev = masked_inputs(g, err_prev, p, decay)
    g, err_prev = g.float(), err_prev.float()
    if mom is not None:
        mom = mom.float()
    mom_out = None if mom is None else fma_f32(mom, momentum, g)
    if mom is None:
        a = err_prev + g
    else:
        a = err_prev + (mom_out if gate is None
                        else torch.where(p, mom_out, 0.0))
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
    out = (a, score, amax, hist.to(torch.int32))
    return out if mom is None else out + (mom_out,)


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


def sweep1_sketch_plain(g, err_prev, rows: int, width: int, gate=None,
                        decay: float = 1.0):
    """Plain version of :func:`sweep1_sketch` in every mode: a = err_prev
    + g in fp32 and its sketch. A bf16 err_prev widens (g stays fp32, as
    the reference casts both to fp32 before its kernel). With ``gate``
    ((1,) fp32, the participation bit p = gate > 0.5) the inputs are the
    reference's masked ones first: g_eff = where(p, g, 0), err_eff =
    where(p, err, decay * err) with the decayed error rounded to the
    state's dtype, so a sitting-out worker's a is its decayed error plus
    +0.0 (a -0.0 error becomes +0.0)."""
    if gate is not None:
        g, err_prev = masked_inputs(g, err_prev, gate.reshape(()) > 0.5,
                                    decay)
    a = err_prev.float() + g
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
# The partitioned encode's index arithmetic, in plain versions
# ---------------------------------------------------------------------------

def fastmod_magic(width: int) -> int:
    """The kernel's 64-bit magic for ``% width``: ceil(2^64 / width) mod
    2^64 (0 for width 1)."""
    return (_U64 // width + 1) & _U64


def fastmod(n: np.ndarray, magic: int, width: int) -> np.ndarray:
    """n % width as the kernel computes it, __umul64hi(magic * n, width),
    with uint64 numpy arithmetic (n < 2^32, width < 2^32)."""
    low = np.asarray(n, dtype=np.uint64) * np.uint64(magic)  # wraps mod 2^64
    w = np.uint64(width)
    lo32, hi32 = low & np.uint64(0xFFFFFFFF), low >> np.uint64(32)
    # high 64 bits of (hi32 * 2^32 + lo32) * w; neither sum overflows
    return (hi32 * w + ((lo32 * w) >> np.uint64(32))) >> np.uint64(32)


def sketch_plan(j: int, rows: int, width: int,
                chunk_pairs: int = CHUNK_PAIRS) -> dict:
    """The partitioned encode's shape: ``chunk`` elements a chunk (a
    multiple of the tile), ``nchunks``, ``per_row`` partitions of
    2^PART_SHIFT buckets a row (covering the first min(width, 2^24)
    buckets), ``parts`` in all, and the pair buffer's ``pair_bytes`` (6 B
    a pair, rows * chunk pairs)."""
    per_row = -(-min(width, HASH_BUCKETS) // (1 << PART_SHIFT))
    parts = rows * per_row
    chunk = max(SKETCH_TILE,
                chunk_pairs // rows // SKETCH_TILE * SKETCH_TILE)
    span = max(1, min(chunk, j))
    return {"chunk": chunk, "nchunks": max(1, -(-j // chunk)),
            "per_row": per_row, "parts": parts,
            "pair_bytes": 6 * rows * span}


def _tiles(n: int) -> int:
    return -(-n // SKETCH_TILE)


def _pair_keys(e0: int, n: int, rows: int, width: int, device=None):
    """For every pair of the elements [e0, e0 + n), in (element, row)
    order: its partition, local bucket and positive-sign flag, as pass 1
    computes them."""
    idx = torch.arange(e0, e0 + n, dtype=torch.int64, device=device)
    per_row = sketch_plan(n, rows, width)["per_row"]
    parts, local, pos = [], [], []
    for r in range(rows):
        h, p = csk.row_hash(r, width, idx)
        parts.append(r * per_row + (h >> PART_SHIFT))
        local.append(h & ((1 << PART_SHIFT) - 1))
        pos.append(p)
    return (torch.stack(parts, 1).reshape(-1),
            torch.stack(local, 1).reshape(-1), torch.stack(pos, 1).reshape(-1))


def sketch_starts_plain(j: int, rows: int, width: int, device=None):
    """(parts, tiles) int64: where each partition's run begins in each
    tile's block of pairs (the pairs of the tile's earlier partitions),
    tiles of SKETCH_TILE elements over the whole J. The start kernel
    writes the same numbers mod 2^16."""
    plan = sketch_plan(j, rows, width)
    parts, tiles = plan["parts"], _tiles(j)
    cnt = torch.zeros((tiles, parts), dtype=torch.int64, device=device)
    step = _PLAIN_ROWS * BLOCK             # a multiple of SKETCH_TILE
    for e0 in range(0, j, step):
        n = min(step, j - e0)
        keys, _, _ = _pair_keys(e0, n, rows, width, device)
        tile = torch.arange(rows * n, device=device) // (rows * SKETCH_TILE)
        t0 = e0 // SKETCH_TILE
        nt = _tiles(n)
        cnt[t0:t0 + nt] += torch.bincount(
            tile * parts + keys, minlength=nt * parts).view(nt, parts)
    return (torch.cumsum(cnt, 1) - cnt).T.contiguous()


def sketch_encode_parts_plain(a, rows: int, width: int,
                              chunk_pairs: int = CHUNK_PAIRS):
    """(sketch, pair ids) of a (J,) through the partitioned encode's steps
    in plain PyTorch. Per chunk, pass 1 writes each tile's pairs as the
    tile's block, in partition order (within a run in element order,
    where the kernel's order is not fixed); pass 2 gathers each
    partition's runs through the start table, sums them with
    ``index_add_`` and writes or adds its slice; buckets from 2^24 on are
    zeroed once. ``pair ids`` holds each chunk's buffer as element * rows
    + row, so a test can see that the blocks hold every pair once."""
    j = a.numel()
    dev = a.device
    plan = sketch_plan(j, rows, width, chunk_pairs)
    starts = sketch_starts_plain(j, rows, width, dev)
    R = 1 << PART_SHIFT
    sk = torch.empty((rows, width), dtype=torch.float32, device=dev)
    sk[:, HASH_BUCKETS:] = 0.0
    ids = []
    for c in range(plan["nchunks"]):
        e0 = c * plan["chunk"]
        n = min(plan["chunk"], j - e0)
        parts, local, pos = _pair_keys(e0, n, rows, width, dev)
        vals = a[e0:e0 + n].repeat_interleave(rows)
        vals = torch.where(pos, vals, -vals)
        # pass 1: each tile's block in partition order
        tile = torch.div(torch.arange(rows * n, device=dev),
                         rows * SKETCH_TILE, rounding_mode="floor")
        order = torch.sort(tile * plan["parts"] + parts, stable=True).indices
        pl, pv = local[order], vals[order]
        ids.append(torch.arange(e0 * rows, (e0 + n) * rows, device=dev)[order])
        # pass 2: one partition at a time, its run of every tile
        t0, nt = e0 // SKETCH_TILE, _tiles(n)
        m = torch.full((nt,), SKETCH_TILE, dtype=torch.int64, device=dev)
        m[-1] = n - (nt - 1) * SKETCH_TILE
        block = torch.arange(nt, device=dev) * rows * SKETCH_TILE
        for p in range(plan["parts"]):
            r, q = divmod(p, plan["per_row"])
            s = starts[p, t0:t0 + nt]
            e = (starts[p + 1, t0:t0 + nt] if p + 1 < plan["parts"]
                 else rows * m)
            lens = e - s
            first = torch.repeat_interleave(block + s, lens)
            within = torch.arange(int(lens.sum()), device=dev) - \
                torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
            at = first + within
            acc = torch.zeros(R, dtype=torch.float32, device=dev)
            acc.index_add_(0, pl[at], pv[at])
            nb = min(R, width - q * R)
            out = sk[r, q * R:q * R + nb]
            out.copy_(acc[:nb] if c == 0 else out + acc[:nb])
    return sk, ids


def sweep1_sketch_parts_plain(g, err_prev, rows: int, width: int,
                              chunk_pairs: int = CHUNK_PAIRS):
    """(a, sketch, pair ids): a = err_prev + g, then
    :func:`sketch_encode_parts_plain` of a, as the fused sweep's passes
    compute them."""
    a = err_prev + g
    return (a, *sketch_encode_parts_plain(a, rows, width, chunk_pairs))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_BF16 = torch.bfloat16


def _vec_ok(*xs) -> int:
    """1 when every tensor's data allows the kernel's 4-element vector
    access (16 bytes of fp32, 8 bytes of bf16)."""
    return int(all(x.data_ptr() % (4 * x.element_size()) == 0 for x in xs))


def _sweep1_outputs(g, out=None, dgc=False):
    """a, score (J,) (``out``'s views where given), amax (rows,), the
    zeroed hist (2048,) int32, and in dgc mode mom' (J,)."""
    rows = rows_of(g.numel())
    if out is None:
        out = tuple(torch.empty_like(g) for _ in range(3 if dgc else 2))
    for name, x in zip(("a", "score", "mom_out"), out):
        _check_vec(name, x, g.numel())
        if x.device != g.device:
            raise ValueError(f"sweep1: {name} must be on g's device")
    return (out[0], out[1],
            torch.empty(rows, dtype=torch.float32, device=g.device),
            torch.zeros(BINS, dtype=torch.int32, device=g.device),
            out[2] if dgc else None)


def _sweep1(fn, g, err_prev, c, mom, momentum, gate, decay, out):
    """Check the inputs and run sweep 1 in the mode the arguments pick
    (dgc with ``mom``, gated with ``gate``, the bf16 read when err_prev
    is bf16): the plain version on the CPU, else the kernel, counted on
    the public wrapper ``fn``. Returns (a, score, amax, hist) and mom'
    in dgc mode."""
    j = g.numel()
    dtype = err_prev.dtype
    if dtype not in (torch.float32, _BF16):
        raise ValueError(f"{fn.__name__}: err_prev must be fp32 or bf16, "
                         f"got {dtype}")
    _check_vec("g", g)
    _check_vec("err_prev", err_prev, j, dtype)
    _check_vec("c", c, 1)
    ins = [g, err_prev, c]
    if mom is not None:
        _check_vec("mom", mom, j, dtype)
        ins.append(mom)
    if gate is not None:
        _check_vec("gate", gate, 1)
        ins.append(gate)
    if len({x.device for x in ins}) != 1:
        raise ValueError(f"{fn.__name__}: every input must share a device")
    if not _on_card(g):
        res = sweep1_plain(g, err_prev, c, mom, momentum, gate, decay)
        if out is None:
            return res
        for dst, src in zip(out, res[:2] + res[4:]):
            dst.copy_(src)
        return tuple(out[:2]) + res[2:4] + tuple(out[2:])
    lib = _lib("sweep1")
    a, score, amax, hist, mom_out = _sweep1_outputs(g, out, mom is not None)
    vec = _vec_ok(*[x for x in (g, err_prev, mom, a, score, mom_out)
                    if x is not None])
    tail = (amax.data_ptr(), hist.data_ptr(), j, _grid(g.device, rows_of(j)),
            vec, _stream(g.device))
    ptr = ctypes.c_void_p
    tail_types = [ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ptr]
    bf16 = "_bf16" if dtype == _BF16 else ""
    if gate is not None:
        launch = getattr(lib, f"sweep1_gated{bf16}_launch")
        args = (g.data_ptr(), err_prev.data_ptr(),
                None if mom is None else mom.data_ptr(), c.data_ptr(),
                gate.data_ptr(), ctypes.c_float(momentum),
                ctypes.c_float(decay), a.data_ptr(), score.data_ptr(),
                None if mom_out is None else mom_out.data_ptr())
        types = [ptr] * 5 + [ctypes.c_float] * 2 + [ptr] * 3
    elif mom is not None:
        launch = getattr(lib, f"sweep1_dgc{bf16}_launch")
        args = (g.data_ptr(), err_prev.data_ptr(), mom.data_ptr(),
                c.data_ptr(), ctypes.c_float(momentum), a.data_ptr(),
                score.data_ptr(), mom_out.data_ptr())
        types = [ptr] * 4 + [ctypes.c_float] + [ptr] * 3
    else:
        launch = getattr(lib, f"sweep1{bf16}_launch")
        args = (g.data_ptr(), err_prev.data_ptr(), c.data_ptr(),
                a.data_ptr(), score.data_ptr())
        types = [ptr] * 5
    launch.restype = ctypes.c_int
    launch.argtypes = types + tail_types
    _check_launch(fn.__name__, launch(*args, *tail))
    fn.launches += 1
    out = (a, score, amax, hist)
    return out if mom is None else out + (mom_out,)


def sweep1(g: torch.Tensor, err_prev: torch.Tensor, c: torch.Tensor,
           mom: torch.Tensor | None = None, momentum: float = 0.0, *,
           out=None):
    """(a, score, amax (rows,), hist (2048,) int32) for g, err_prev (J,)
    fp32 and c (1,) fp32, all on one device. With ``mom`` (J,) the dgc
    mode (:func:`sweep1_dgc`): mom' = momentum * mom + g, a = err_prev +
    mom', and mom' is returned last. A bf16 err_prev runs the bf16 read
    (:func:`sweep1_bf16`). ``out``: (a, score[, mom']) (J,) fp32 tensors
    to write into (views of larger buffers, as the bucketed pipeline
    passes), else new ones."""
    if mom is not None:
        return sweep1_dgc(g, err_prev, mom, c, momentum, out=out)
    if err_prev.dtype == _BF16:
        return sweep1_bf16(g, err_prev, c, out=out)
    return _sweep1(sweep1, g, err_prev, c, None, 0.0, None, 1.0, out)


def sweep1_bf16(g: torch.Tensor, err_prev: torch.Tensor, c: torch.Tensor,
                *, out=None):
    """Sweep 1's plain mode reading a bf16 err_prev (J,): g is rounded to
    bf16 and err_prev widened in registers, the outputs are fp32, bit for
    bit the fp32 kernel's on (g.bfloat16().float(), err_prev.float()).
    Its own ``launches`` count."""
    _check_vec("err_prev", err_prev, dtype=_BF16)
    return _sweep1(sweep1_bf16, g, err_prev, c, None, 0.0, None, 1.0, out)


def sweep1_dgc(g: torch.Tensor, err_prev: torch.Tensor, mom: torch.Tensor,
               c: torch.Tensor, momentum: float, *, out=None):
    """Sweep 1 in dgc mode: (a, score, amax, hist, mom') with mom' =
    momentum * mom + g (momentum rounded to fp32), a = err_prev + mom'
    and score = a * c; g, err_prev, mom (J,) fp32 and c (1,) fp32 on one
    device (bf16 err_prev and mom: :func:`sweep1_dgc_bf16`). Its own
    ``launches`` count shows which mode a run took."""
    if err_prev.dtype == _BF16:
        return sweep1_dgc_bf16(g, err_prev, mom, c, momentum, out=out)
    return _sweep1(sweep1_dgc, g, err_prev, c, mom, momentum, None, 1.0, out)


def sweep1_dgc_bf16(g: torch.Tensor, err_prev: torch.Tensor,
                    mom: torch.Tensor, c: torch.Tensor, momentum: float, *,
                    out=None):
    """Sweep 1's dgc mode reading bf16 err_prev and mom (J,); mom' and
    every other output fp32."""
    _check_vec("err_prev", err_prev, dtype=_BF16)
    return _sweep1(sweep1_dgc_bf16, g, err_prev, c, mom, momentum, None, 1.0,
                   out)


def sweep1_gated(g: torch.Tensor, err_prev: torch.Tensor, c: torch.Tensor,
                 gate: torch.Tensor, decay: float,
                 mom: torch.Tensor | None = None, momentum: float = 0.0, *,
                 out=None):
    """Sweep 1 under elastic participation, both modes: the inputs masked
    in registers by the participation bit p = gate > 0.5 (gate a (1,)
    fp32 on the device, so the schedule needs no host read) and the
    error-feedback decay ``decay`` (rounded to fp32), g_eff = p ? g : 0,
    err_eff = p ? err_prev : decay * err_prev; then plain mode, (a,
    score, amax, hist) with a = err_eff + g_eff, or with ``mom`` the dgc
    mode, (a, score, amax, hist, mom') with mom' = momentum * mom + g_eff
    and a = err_eff + (p ? mom' : 0). Its own ``launches`` count covers
    both modes (bf16 state: :func:`sweep1_gated_bf16`)."""
    if err_prev.dtype == _BF16:
        return sweep1_gated_bf16(g, err_prev, c, gate, decay, mom, momentum,
                                 out=out)
    return _sweep1(sweep1_gated, g, err_prev, c, mom, momentum, gate, decay,
                   out)


def sweep1_gated_bf16(g: torch.Tensor, err_prev: torch.Tensor,
                      c: torch.Tensor, gate: torch.Tensor, decay: float,
                      mom: torch.Tensor | None = None, momentum: float = 0.0,
                      *, out=None):
    """The gated variant reading bf16 err_prev (and mom): a sitting-out
    worker's decayed error is rounded back to bf16 before the add."""
    _check_vec("err_prev", err_prev, dtype=_BF16)
    return _sweep1(sweep1_gated_bf16, g, err_prev, c, mom, momentum, gate,
                   decay, out)


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


def _sweep1_sketch(fn, g, err_prev, rows: int, width: int, tables, gate,
                   decay: float):
    """Check the inputs and run B3 in the mode the arguments pick (gated
    with ``gate``, the bf16 read when err_prev is bf16): the plain
    version on the CPU, else the kernel, counted on the public wrapper
    ``fn``."""
    j = g.numel()
    dtype = err_prev.dtype
    if dtype not in (torch.float32, _BF16):
        raise ValueError(f"{fn.__name__}: err_prev must be fp32 or bf16, "
                         f"got {dtype}")
    _check_vec("g", g)
    _check_vec("err_prev", err_prev, j, dtype)
    ins = [g, err_prev]
    if gate is not None:
        _check_vec("gate", gate, 1)
        ins.append(gate)
    if len({x.device for x in ins}) != 1:
        raise ValueError(f"{fn.__name__}: every input must share a device")
    csk.check_shape(j, rows, width)
    if not _on_card(g):
        return sweep1_sketch_plain(g, err_prev, rows, width, gate, decay)
    a = torch.empty_like(g)
    sk = _encode_card(g, err_prev, a, rows, width,
                      _start_table(g.device, j, rows, width, tables),
                      gate, decay)
    fn.launches += 1
    return a, sk


def sweep1_sketch(g: torch.Tensor, err_prev: torch.Tensor, rows: int,
                  width: int, tables: dict | None = None):
    """(a (J,) fp32, CountSketch of a (rows, width) fp32) for g, err_prev
    (J,) fp32 on one device; a = err_prev + g (a bf16 err_prev runs
    :func:`sweep1_sketch_bf16`).

    On the card the encode reads a start table of its shape (J, rows,
    width), which a count kernel builds without reading data (142 MB at
    J = 892,032,000, 3 rows, width 3,568,128). ``tables`` is a dict that
    the caller owns and keeps across calls: the table is built into it
    at the first call of a shape and reused after, and it lives as long
    as the dict. Without it the table is built for the call alone. Both
    encodes key the dict alike, so they share a table."""
    if err_prev.dtype == _BF16:
        return sweep1_sketch_bf16(g, err_prev, rows, width, tables)
    return _sweep1_sketch(sweep1_sketch, g, err_prev, rows, width, tables,
                          None, 1.0)


def sweep1_sketch_bf16(g: torch.Tensor, err_prev: torch.Tensor, rows: int,
                       width: int, tables: dict | None = None):
    """B3 reading a bf16 err_prev (J,), widened in registers (exact); g
    and a stay fp32, so every output equals the fp32 kernel's on
    (g, err_prev.float()). Its own ``launches`` count."""
    _check_vec("err_prev", err_prev, dtype=_BF16)
    return _sweep1_sketch(sweep1_sketch_bf16, g, err_prev, rows, width,
                          tables, None, 1.0)


def sweep1_sketch_gated(g: torch.Tensor, err_prev: torch.Tensor,
                        gate: torch.Tensor, decay: float, rows: int,
                        width: int, tables: dict | None = None):
    """B3 under elastic participation: the inputs masked in registers by
    the participation bit p = gate > 0.5 (gate a (1,) fp32 on the device)
    and the error-feedback decay ``decay`` (rounded to fp32), g_eff =
    p ? g : 0, err_eff = p ? err : decay * err, then a = err_eff + g_eff
    and its sketch, as the reference's ``masked_inputs`` feeds its
    kernel. Its own ``launches`` count (bf16 state:
    :func:`sweep1_sketch_gated_bf16`)."""
    if err_prev.dtype == _BF16:
        return sweep1_sketch_gated_bf16(g, err_prev, gate, decay, rows,
                                        width, tables)
    return _sweep1_sketch(sweep1_sketch_gated, g, err_prev, rows, width,
                          tables, gate, decay)


def sweep1_sketch_gated_bf16(g: torch.Tensor, err_prev: torch.Tensor,
                             gate: torch.Tensor, decay: float, rows: int,
                             width: int, tables: dict | None = None):
    """The gated form reading a bf16 err_prev: a sitting-out worker's
    decayed error is rounded to bf16 before it is widened and added."""
    _check_vec("err_prev", err_prev, dtype=_BF16)
    return _sweep1_sketch(sweep1_sketch_gated_bf16, g, err_prev, rows,
                          width, tables, gate, decay)


def sketch_encode(a: torch.Tensor, rows: int, width: int,
                  tables: dict | None = None):
    """CountSketch (rows, width) fp32 of a (J,) fp32, through the same
    passes and start table as :func:`sweep1_sketch` (``tables`` as
    there)."""
    j = a.numel()
    _check_vec("a", a)
    csk.check_shape(j, rows, width)
    if not _on_card(a):
        return sketch_encode_plain(a, rows, width)
    sk = _encode_card(a, None, None, rows, width,
                      _start_table(a.device, j, rows, width, tables))
    sketch_encode.launches += 1
    return sk


def _start_table(dev, j: int, rows: int, width: int, tables):
    """The start table of the shape from ``tables`` (built into it at the
    first call of the shape), or built for the call alone without it."""
    key = (dev, j, rows, width)
    start = None if tables is None else tables.get(key)
    if start is None:
        start = sketch_starts(dev, j, rows, width)
        if tables is not None:
            tables[key] = start
    return start


def sketch_starts(dev, j: int, rows: int, width: int) -> torch.Tensor:
    """The start kernel's (parts, tiles) table on the card, uint16 bits
    in an int16 tensor (no data read)."""
    fn = _lib("sketch_parts").sketch_parts_start_launch
    plan = sketch_plan(j, rows, width)
    tiles = _tiles(j)
    start = torch.empty((plan["parts"], tiles), dtype=torch.int16,
                        device=dev)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    mults, adds = _hash_args(rows)
    _check_launch("sketch_parts_start", fn(
        start.data_ptr(), mults, adds, rows, width, fastmod_magic(width), j,
        _grid(dev, tiles), _stream(dev)))
    return start


def _encode_card(x, err_prev, a, rows: int, width: int, start, gate=None,
                 decay: float = 1.0):
    """The partitioned encode on the card through the start table
    ``start`` of its shape: the sketch of err_prev + x, written with a
    into ``a`` (the fused sweep: an fp32 or bf16 err_prev, gated by
    ``gate`` where given), or of x itself when err_prev is None (the
    encode)."""
    dev = x.device
    j = x.numel()
    plan = sketch_plan(j, rows, width)
    sk = torch.empty((rows, width), dtype=torch.float32, device=dev)
    sk[:, HASH_BUCKETS:] = 0.0
    npairs = plan["pair_bytes"] // 6
    pl = torch.empty(npairs, dtype=torch.int16, device=dev)   # uint16 bits
    pv = torch.empty(npairs, dtype=torch.float32, device=dev)
    fused = err_prev is not None
    ins = [x, err_prev, a] if fused else [x]
    lib = _lib("sketch_parts")
    ptr = ctypes.c_void_p
    if not fused:
        fn, name, extra, extra_types = (lib.sketch_encode_launch,
                                        "sketch_encode", [], [])
    else:
        bf16 = "_bf16" if err_prev.dtype == _BF16 else ""
        gated = "_gated" if gate is not None else ""
        name = f"sweep1_sketch{gated}{bf16}"
        fn = getattr(lib, f"{name}_launch")
        extra, extra_types = (([gate.data_ptr(), ctypes.c_float(decay)],
                               [ptr, ctypes.c_float]) if gated else
                              ([], []))
    fn.restype = ctypes.c_int
    fn.argtypes = [ptr] * len(ins) + extra_types + [ptr] * 6 + [
        ctypes.c_int, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    mults, adds = _hash_args(rows)
    err = fn(*(t.data_ptr() for t in ins), *extra,
             *(t.data_ptr() for t in (sk, pl, pv, start)), mults, adds,
             rows, width, fastmod_magic(width), j, plan["chunk"],
             _grid(dev, _tiles(min(plan["chunk"], max(j, 1))), 1),
             _vec_ok(*ins) if fused else _aligned(*ins), _stream(dev))
    _check_launch(name, err)
    return sk


KERNELS = (sweep1, sweep1_dgc, sweep1_gated, sweep1_bf16, sweep1_dgc_bf16,
           sweep1_gated_bf16, sweep2, sweep1_sketch, sweep1_sketch_bf16,
           sweep1_sketch_gated, sweep1_sketch_gated_bf16, sketch_encode)
for _fn in KERNELS:
    _fn.launches = 0


# Byte contracts: what each kernel must move at flat length j, each input
# read once and each output written once (the bound column of the
# kernels' table and the dry run's count of the stages that read the
# device on the host). Sweep 1 reads g (fp32) and the state (4 or 2
# bytes: ``state``), writes a and score (fp32), and, in dgc mode, reads
# the momentum and writes mom' (fp32); per tile an amax, and the 2048-bin
# histogram; the gated form reads the bit and the decay too.
def _sweep1_bytes(j: int, state: int, dgc: bool, gated: bool) -> int:
    per = 4 + state + 8 + (state + 4 if dgc else 0)
    return per * j + 4 * rows_of(j) + 4 * BINS + (8 if gated else 0)


def _sketch_bytes(j: int, rows: int, width: int, state: int,
                  gated: bool) -> int:
    """Sweep 1 with the sketch: g, the state and a, and the (rows,
    width) fp32 sketch (its tables are the design's, not the contract's)."""
    return (8 + state) * j + 4 * rows * width + (4 if gated else 0)


sweep1.bytes_moved = lambda j: _sweep1_bytes(j, 4, False, False)
sweep1_dgc.bytes_moved = lambda j: _sweep1_bytes(j, 4, True, False)
sweep1_gated.bytes_moved = \
    lambda j, dgc=False: _sweep1_bytes(j, 4, dgc, True)
sweep1_bf16.bytes_moved = lambda j: _sweep1_bytes(j, 2, False, False)
sweep1_dgc_bf16.bytes_moved = lambda j: _sweep1_bytes(j, 2, True, False)
sweep1_gated_bf16.bytes_moved = \
    lambda j, dgc=False: _sweep1_bytes(j, 2, dgc, True)
# sweep 2 reads the score and writes each tile's maxpb slots and count
sweep2.bytes_moved = \
    lambda j, maxpb: 4 * j + 8 * rows_of(j) * maxpb + 4 * rows_of(j)
sweep1_sketch.bytes_moved = \
    lambda j, rows, width: _sketch_bytes(j, rows, width, 4, False)
sweep1_sketch_gated.bytes_moved = \
    lambda j, rows, width: _sketch_bytes(j, rows, width, 4, True)
sweep1_sketch_bf16.bytes_moved = \
    lambda j, rows, width: _sketch_bytes(j, rows, width, 2, False)
sweep1_sketch_gated_bf16.bytes_moved = \
    lambda j, rows, width: _sketch_bytes(j, rows, width, 2, True)
# the encode reads a and writes the sketch
sketch_encode.bytes_moved = lambda j, rows, width: 4 * j + 4 * rows * width


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
