"""Density allocation: the budget k split over contiguous segments of the
flat gradient before selection (the port of ``repro.core.allocate``).

A segment is a contiguous slice of the flat gradient: the near-equal cut
of :func:`segment_bounds`, or the leaf-aligned "layer" cut of
:func:`layer_segments` over ``TreeFlattener.layer_bounds()``, which the
train step passes. ``SparsifierConfig.allocation`` picks the split:

- ``"global"``: one top-k over the whole vector (nothing here runs);
- ``"proportional"``: k_l proportional to J_l (largest remainder,
  Python ints);
- ``"adaptive"``: k_l from each segment's second moment, the sum of the
  squares of its top-``cap_l`` selection keys, with the per-element
  intensity clipped to [1/ADAPTIVE_CLIP, ADAPTIVE_CLIP] of the mean.

Every mode conserves sum(k_l) == k, so the packed wire is unchanged.

The adaptive split is fp32 arithmetic in the reference, compiled by XLA;
a count is a difference of ``round(cumsum(quota))``, so one ulp at a .5
boundary moves an entry between segments. The port follows the compiled
program's forms: a division by a constant (``total / J``, ``m / J_l``) is
a multiply by the fp32 reciprocal; ``float(k) * w`` is (sel * J_l) * k,
except that with all J_l equal XLA folds J_l * k into one constant
(rounded once); ``round`` is half to even; every sum adds in XLA's CPU
order (``numerics.xla_sum_f32``: windows of 32, each in order), and the
cumsum adds in order up to 16 quotas, in rows of 16 past that
(:func:`_cumsum_f32`). The moments are
summed on the tensors' device; the O(S) split itself runs on the host in
numpy fp32 scalars (the moments are read back once), which round as the
compiled program does and give Python ints.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import bigvec, select
from repro_torch.core.flatten import bucket_bounds
from repro_torch.core.numerics import XLA_REDUCE_WINDOW, xla_sum_f32

ALLOCATION_MODES = ("global", "proportional", "adaptive")
# kinds with a per-worker compress step that can honour per-segment counts
ALLOCATED_KINDS = ("topk", "dgc", "regtopk", "thresholdk", "randk")
# near-equal segment count when num_segments=0 and buckets do not decide
DEFAULT_SEGMENTS = 8
# adaptive intensity clip: quotas deviate at most ADAPTIVE_CLIP**2 x from
# the proportional share
ADAPTIVE_CLIP = 2.0
# additive per-segment provisioning headroom over the clipped quota
ADAPTIVE_SLACK = 64

_F32 = np.float32
# XLA's CPU backend scans (cumsum) longer vectors in rows of this many
_XLA_SCAN_BLOCK = 16


def check_allocation(cfg) -> None:
    """Raise the reference's ValueError for a config the allocation cannot
    serve; allocation="global" is always valid."""
    if cfg.allocation not in ALLOCATION_MODES:
        raise ValueError(f"unknown allocation {cfg.allocation!r}; "
                         f"known: {ALLOCATION_MODES}")
    if cfg.allocation == "global":
        return
    if cfg.kind not in ALLOCATED_KINDS:
        raise ValueError(
            f"allocation={cfg.allocation!r} needs a per-worker compress "
            f"step that can honor per-segment counts; kind={cfg.kind!r} "
            "selects at the aggregate/sketch level (supported kinds: "
            f"{ALLOCATED_KINDS})")
    if cfg.kind != "randk" and cfg.selector != "exact":
        raise ValueError(
            f"allocation={cfg.allocation!r} requires selector='exact': "
            "per-segment budget conservation (sum k_l == k) needs "
            "exact-count selection, and the histogram selector "
            f"over-selects per threshold (got selector={cfg.selector!r})")
    if (cfg.kind == "regtopk" and cfg.pipeline != "fused"
            and cfg.state_format == "sparse"):
        raise ValueError(
            "allocation != 'global' is not implemented for the reference "
            "pipeline's regtopk state_format='sparse' layout; use "
            "state_format='dense' or pipeline='fused'")


def resolve_num_segments(cfg, j: int) -> int:
    """cfg.num_segments, with 0 resolved to the bucket count when
    num_buckets > 1, else DEFAULT_SEGMENTS; clamped to [1, j]."""
    ns = int(cfg.num_segments)
    if ns <= 0:
        ns = cfg.num_buckets if cfg.num_buckets > 1 else DEFAULT_SEGMENTS
    return max(1, min(ns, max(1, int(j))))


def segment_bounds(j: int, num_segments: int) -> list:
    """Near-equal contiguous cut of [0, j): the bucket rule."""
    return bucket_bounds(j, num_segments)


def layer_segments(leaves, max_segments: int) -> list:
    """Group consecutive leaves (sizes, or (offset, size) pairs) into at
    most ``max_segments`` contiguous segments of near-equal size, never
    cutting a leaf; [(offset, size), ...], every segment non-empty."""
    sizes = [int(x[1]) if isinstance(x, (tuple, list)) else int(x)
             for x in leaves]
    j = sum(sizes)
    if j <= 0:
        return [(0, 0)]
    n = len(sizes)
    # positive leaves from i on: a cut must leave one per later segment
    pos_after = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        pos_after[i] = pos_after[i + 1] + (1 if sizes[i] > 0 else 0)
    s = max(1, min(int(max_segments), pos_after[0]))
    bounds, off, i, rem_j = [], 0, 0, j
    for seg in range(s):
        rem_segs = s - seg
        if rem_segs == 1:
            bounds.append((off, j - off))
            break
        target = rem_j / rem_segs
        acc = 0
        while i < n:
            take = sizes[i]
            if acc > 0 and pos_after[i] <= rem_segs - 1:
                break                       # leaves reserved for the rest
            if acc > 0 and abs(acc + take - target) > abs(acc - target):
                break                       # the next leaf overshoots
            acc += take
            i += 1
        bounds.append((off, acc))
        off += acc
        rem_j -= acc
    return bounds


def segment_caps(k: int, sizes) -> list:
    """The most entries any mode may give segment l: min(J_l, k,
    ceil(ADAPTIVE_CLIP**2 * k * J_l / J) + ADAPTIVE_SLACK)."""
    sizes = [int(x) for x in sizes]
    j = sum(sizes)
    k = int(min(k, j))
    caps = [int(min(sz, k, math.ceil(ADAPTIVE_CLIP ** 2 * k * sz / j)
                    + ADAPTIVE_SLACK)) for sz in sizes]
    assert sum(caps) >= k, (k, sizes, caps)
    return caps


def proportional_counts(k: int, sizes) -> list:
    """Largest-remainder apportionment of k over the sizes (sum == k, 0
    <= k_l <= J_l), with one per segment when k >= S."""
    sizes = [int(x) for x in sizes]
    s, j = len(sizes), sum(sizes)
    k = int(min(k, j))
    base = [(k * sz) // j for sz in sizes]
    rems = [(k * sz) % j for sz in sizes]
    extra = k - sum(base)
    for i in sorted(range(s), key=lambda t: (-rems[t], t))[:extra]:
        base[i] += 1
    if k >= s:
        for i in range(s):
            while base[i] < 1:
                d = max(range(s), key=lambda t: (base[t], -t))
                base[d] -= 1
                base[i] += 1
    return base


def _sum_f32(x: np.ndarray) -> np.float32:
    """numpy's side of ``xla_sum_f32`` (S values: windows of 32)."""
    x = np.asarray(x, _F32)
    w = XLA_REDUCE_WINDOW
    while x.size > w:
        pad = -(-x.size // w) * w - x.size
        x = np.pad(x, (pad // 2, pad - pad // 2)).reshape(-1, w)
        acc = np.zeros(x.shape[0], _F32)
        for c in range(w):
            acc = acc + x[:, c]
        x = acc
    acc = _F32(0.0)
    for v in x:
        acc = _F32(acc + v)
    return acc


def _cumsum_f32(x: np.ndarray) -> np.ndarray:
    """fp32 inclusive cumsum in XLA's CPU order: in order up to
    _XLA_SCAN_BLOCK elements; past that the vector is zero-padded at the
    end to rows of _XLA_SCAN_BLOCK, each row is scanned in order, and
    each row's scan is offset by the (recursive) exclusive scan of the
    row totals."""
    x = np.asarray(x, _F32)
    b = _XLA_SCAN_BLOCK
    if x.size <= b:
        out = np.empty(x.shape, _F32)
        acc = _F32(0.0)
        for i, v in enumerate(x):
            acc = _F32(acc + v)
            out[i] = acc
        return out
    rows = -(-x.size // b)
    within = np.stack([_cumsum_f32(r) for r in np.concatenate(
        [x, np.zeros(rows * b - x.size, _F32)]).reshape(rows, b)])
    before = np.concatenate([np.zeros(1, _F32),
                             _cumsum_f32(within[:, -1])[:-1]])
    return (within + before[:, None]).reshape(-1)[:x.size]


def _excl_cumsum(x: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(x)[:-1]]).astype(x.dtype)


def _integerize_counts(quota: np.ndarray, caps, k: int, lo: int) -> list:
    """Cumulative rounding of fp32 quotas to ints summing to k (XLA's
    cumsum, round half to even), cap overflow moved to headroom in
    index order, then the floor ``lo`` raised from surplus in index
    order."""
    cum = np.minimum(np.round(_cumsum_f32(quota)), _F32(k))
    cum[-1] = _F32(k)
    kl = np.diff(np.concatenate([np.zeros(1, _F32), cum])).astype(np.int32)
    caps = np.asarray(caps, np.int32)
    over = np.maximum(kl - caps, 0)
    kl = kl - over
    head = caps - kl
    kl = kl + np.clip(over.sum() - _excl_cumsum(head), 0, head)
    if lo:
        short = np.maximum(lo - kl, 0).sum()
        kl = np.maximum(kl, lo)
        sur = kl - lo
        kl = kl - np.clip(short - _excl_cumsum(sur), 0, sur)
    return [int(x) for x in kl]


def adaptive_counts(k: int, sizes, moments, caps=None) -> list:
    """The adaptive split of k from the (S,) second moments (a tensor on
    any device, or an array): intensity m_l / J_l against the mean,
    clipped, quotas k-proportional to J_l * ratio_l, integerized
    exactly. Python ints, sum == k, k_l <= caps_l, k_l >= 1 when k >= S;
    all-zero moments give the proportional split. The reference's fp32
    forms, evaluated on the host."""
    sizes = [int(x) for x in sizes]
    s, j = len(sizes), sum(sizes)
    k = int(min(k, j))
    caps = caps if caps is not None else segment_caps(k, sizes)
    if isinstance(moments, torch.Tensor):
        # a device-to-host read of the step
        trace.count("host_reads", site="adaptive_counts")
        with trace.span("compress/trim/read", site="adaptive_counts"):
            moments = moments.detach().cpu().numpy()
    m = np.maximum(np.asarray(moments, _F32), _F32(0.0))
    sz = np.asarray(sizes, _F32)
    total = _sum_f32(m)
    mean = np.maximum(_F32(total * (_F32(1.0) / _F32(j))), _F32(1e-30))
    ratio = np.clip((m * (_F32(1.0) / sz)) / mean, _F32(1.0 / ADAPTIVE_CLIP),
                    _F32(ADAPTIVE_CLIP))
    sel = ratio if total > 0 else np.ones(s, _F32)
    w = sel * sz
    if len(set(sizes)) == 1:
        # equal sizes make J_l a broadcast constant, and XLA folds the two
        # constant factors of (sel * J_l) * k into one, rounded once
        quota = (sel * _F32(sz[0] * _F32(k))) / _sum_f32(w)
    else:
        quota = (w * _F32(k)) / _sum_f32(w)
    return _integerize_counts(quota, caps, k, lo=1 if k >= s else 0)


def allocated_select_dense(keys: torch.Tensor, bounds, caps, counts,
                           k: int) -> torch.Tensor:
    """Per-segment top-``counts[l]`` over DENSE keys (non-negative fp32),
    packed to exactly k int64 indices: each segment's top-``caps[l]`` in
    ``lax.top_k`` order with the leading ``counts[l]`` live, then one
    top-k over the live-masked union (ties segment-major, index
    ascending)."""
    parts_v, parts_i = [], []
    for (off, size), cap, kl in zip(bounds, caps, counts):
        pos = select.topk_positions(keys[off:off + size], int(cap))
        kv = keys[off + pos]
        live = torch.arange(int(cap), device=keys.device) < int(kl)
        parts_v.append(torch.where(live, kv, float("-inf")))
        parts_i.append(pos + off)
    allv, alli = torch.cat(parts_v), torch.cat(parts_i)
    return alli[select.topk_positions(allv, int(k))]


def square_mass(tv: torch.Tensor) -> torch.Tensor:
    """0-d sum of the squares of the finite keys of ``tv``, in the
    compiled reference's order (``numerics.xla_sum_f32``)."""
    return xla_sum_f32(torch.where(tv > float("-inf"), tv * tv, 0.0))


def dense_segment_moments(keys: torch.Tensor, bounds, caps) -> torch.Tensor:
    """(S,) adaptive statistics from dense keys: each segment's top-cap
    square mass."""
    out = []
    for (off, size), cap in zip(bounds, caps):
        seg = keys[off:off + size]
        out.append(square_mass(seg[select.topk_positions(seg, int(cap))]))
    return torch.stack(out)


def resolve_counts(allocation: str, k: int, bounds, caps,
                   moments=None) -> list:
    """Per-segment budget (Python ints) of an allocated mode; "adaptive"
    needs ``moments``."""
    sizes = [sz for _, sz in bounds]
    if allocation == "adaptive":
        if moments is None:
            raise ValueError("allocation='adaptive' needs per-segment "
                             "moment statistics")
        return adaptive_counts(k, sizes, moments, caps=caps)
    if allocation == "proportional":
        return proportional_counts(k, sizes)
    raise ValueError(f"not an allocated mode: {allocation!r}")


def reference_allocated_select(cfg, a: torch.Tensor, score: torch.Tensor,
                               k: int, seg_bounds=None):
    """The reference pipeline's allocated selection: (mask (J,) of a's
    dtype, values (k,), indices (k,) int32 bits). ``score`` is the dense
    selection score (REGTOP-k-corrected for that kind), ``a`` the
    accumulator the values are read from."""
    j = score.numel()
    bounds = seg_bounds or segment_bounds(j, resolve_num_segments(cfg, j))
    caps = segment_caps(k, [sz for _, sz in bounds])
    keys = score.float().abs()
    moments = (dense_segment_moments(keys, bounds, caps)
               if cfg.allocation == "adaptive" else None)
    counts = resolve_counts(cfg.allocation, k, bounds, caps, moments)
    idx = allocated_select_dense(keys, bounds, caps, counts, k)
    del keys
    mask = bigvec.mask_from_indices(j, idx, a.dtype)
    return mask, a[idx], bigvec.to_u32_bits(idx)


def randk_allocated_indices(key: torch.Tensor, bounds, counts
                            ) -> torch.Tensor:
    """Allocated RANDOM-k: segment l draws a uniform k_l-subset with
    ``fold_in(key, l)`` (the proportional counts; there is no score to
    adapt to). (k,) int64 global indices, segment-major."""
    from repro_torch.core import threefry
    parts = [off + select.randk_indices(threefry.fold_in(key, pos), size,
                                        int(kl))
             for pos, ((off, size), kl) in enumerate(zip(bounds, counts))
             if int(kl) > 0]
    return torch.cat(parts)
