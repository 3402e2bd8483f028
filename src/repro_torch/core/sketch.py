"""CountSketch coordination of global TOP-k (the port of
``repro.core.sketch``).

Every worker encodes its accumulated gradient a_n into a (rows, width)
CountSketch; one all-reduce of the sketches gives the sketch of the
aggregated a (sketches are linear); every rank decodes the same
magnitude estimates for all J entries (median over rows) and so selects
the same top-k mask, and only the k selected values travel
(``core.aggregate``).

Hashing is stateless and bit-identical to the reference: for row r and
element index i, x = (i * MULTS[r] + ADDS[r]) mod 2^32, bucket
(x >> 8) mod width, sign +1 when bit 31 of x is set, else -1. torch has
no uint32 arithmetic, so the hash is computed in int64 and masked to 32
bits: the low 32 bits of a product survive int64 wraparound, so this is
exact for every i < 2^32. Larger J raises, where the reference's uint32
index stream would wrap.

``encode`` is the wrapper of the encode kernel (B4,
``kernels.compress.kernel.sketch_encode``); ``estimate`` is plain
PyTorch, chunked over J so it never materialises the (rows, J) hash,
sign and value arrays (~32 GB at J = 892 M).
"""
from __future__ import annotations

import functools
import math
import warnings

import torch

# fixed odd multipliers (Knuth multiplicative hashing), one pair per row:
# the reference's constants (uint32 values as Python ints)
MULTS = (2654435761, 2246822519, 3266489917, 668265263,
         374761393, 2654435789, 1597334677, 2869860233)
ADDS = (374761393, 3266489917, 1181783497, 2549297995,
        4279918613, 1609587929, 2246822519, 2654435761)
MAX_ROWS = len(MULTS)
_WIDTH_CAP = 1 << 22
_U32 = 0xFFFFFFFF
_ESTIMATE_CHUNK = 1 << 24     # elements per estimate chunk (bounds memory)

# k values already warned about: the width cap is surfaced once per
# process per k, as in the reference
_CAP_WARNED: set = set()


def resolve_width(k: int, width: int = 0) -> int:
    """Effective sketch width: the explicit ``width`` verbatim, else 4*k
    clamped to [256, 2^22], warning once per k at the upper cap (the
    capped sketch packs more coordinates per bucket than the 4x
    provisioning assumes)."""
    if width:
        return int(width)
    w = max(4 * k, 256)
    if w > _WIDTH_CAP:
        if k not in _CAP_WARNED:
            _CAP_WARNED.add(k)
            warnings.warn(
                f"sketch width 4*k = {w} exceeds the {_WIDTH_CAP} "
                f"auto-width cap at k={k}; the capped sketch packs "
                f"~{4 * k / _WIDTH_CAP:.1f}x more coordinates per bucket "
                "than the 4x provisioning assumes, degrading the "
                "magnitude estimates. Set SparsifierConfig.sketch_width "
                "explicitly to override the cap.",
                RuntimeWarning, stacklevel=2)
        return _WIDTH_CAP
    return int(w)


def check_shape(j: int, rows: int, width: int) -> None:
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"sketch rows={rows} outside [1, {MAX_ROWS}]")
    if not 1 <= width <= _U32:
        raise ValueError(f"sketch width={width} outside [1, 2^32)")
    if j >= 1 << 32:
        raise ValueError(f"J={j} needs element indices beyond uint32, where "
                         "the reference's hash stream wraps")


def row_hash(r: int, width: int, idx: torch.Tensor):
    """(bucket int64, positive bool) of row r for the int64 element
    indices ``idx``."""
    x = (idx * MULTS[r] + ADDS[r]) & _U32
    return (x >> 8) % width, x >= 1 << 31


def hashes(j: int, rows: int, width: int, device="cpu"):
    """(h (rows, J) int64 buckets, s (rows, J) fp32 +-1 signs), the
    reference's ``_hashes``. Materialises (rows, J): for tests and small
    J only; the encode and the estimate hash chunk by chunk."""
    check_shape(j, rows, width)
    idx = torch.arange(j, dtype=torch.int64, device=device)
    hs, ss = zip(*(row_hash(r, width, idx) for r in range(rows)))
    sign = torch.stack(ss).float() * 2.0 - 1.0
    return torch.stack(hs), sign


def encode(a: torch.Tensor, rows: int, width: int,
           tables: dict | None = None) -> torch.Tensor:
    """a (J,) fp32 -> CountSketch (rows, width) fp32 (kernel B4 on the
    card, its plain version on the CPU). ``tables``: the caller's dict of
    the kernel's start tables, kept across calls
    (``kernel.sketch_encode``)."""
    from repro_torch.kernels.compress import kernel as pk
    return pk.sketch_encode(a, rows, width, tables)


def _sort_rows(vals: list) -> list:
    """The rows sorted elementwise (odd-even transposition network of
    min/max; rows <= 8). ``torch.sort`` along a dimension of 3 runs a
    segmented radix sort that took ~45 ms per 2^24 columns on the H100."""
    vals = list(vals)
    for p in range(len(vals)):
        for i in range(p % 2, len(vals) - 1, 2):
            vals[i], vals[i + 1] = (torch.minimum(vals[i], vals[i + 1]),
                                    torch.maximum(vals[i], vals[i + 1]))
    return vals


def estimate(sketch: torch.Tensor, j: int) -> torch.Tensor:
    """Magnitude estimates (J,) fp32 for all J entries: per row the signed
    bucket value s_r * sketch[r, h_r(i)], then the median over rows as
    ``jnp.median`` computes it: any NaN in a column gives NaN, else the
    sorted column's (lower + upper middle) * 0.5, which for an even row
    count averages the two middle values (``torch.median`` would return
    the lower one). Where the middle values are zeros of both signs,
    which zero the median carries is unspecified here as in jnp's
    unstable sort; only |estimate| is used."""
    rows, width = sketch.shape
    check_shape(j, rows, width)
    q = 0.5 * (rows - 1)
    lower, upper = math.floor(q), math.ceil(q)
    dev = sketch.device
    out = torch.empty(j, dtype=torch.float32, device=dev)
    for lo in range(0, j, _ESTIMATE_CHUNK):
        hi = min(j, lo + _ESTIMATE_CHUNK)
        idx = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        vals = []
        for r in range(rows):
            h, pos = row_hash(r, width, idx)
            v = sketch[r][h]
            vals.append(torch.where(pos, v, -v))    # s * v, exact
        nan = functools.reduce(torch.logical_or, map(torch.isnan, vals))
        srt = _sort_rows(vals)
        med = (srt[lower] + srt[upper]) * 0.5
        out[lo:hi] = med.masked_fill_(nan, float("nan"))
    return out
