"""Top-k selection over flat score vectors (the port's ``repro.core.select``).

Three selectors, as in the reference: ``exact`` (``lax.top_k`` order on
|score|, exactly k entries), ``histogram`` (threshold at a bin edge of a
linear magnitude histogram, plain tensor ops) and ``histogram_kernel``
(the same threshold through the histogram kernel,
``kernels.topk_select``). The histogram selectors select every entry with
|score| >= tau, which is at least k of them.

The reference's exact selector is ``lax.top_k``: keys descending, ties
broken by position ascending. ``torch.topk`` orders ties in no stated
way (on torch 2.13's CPU build ``topk([1,3,3,2,3], 2)`` returns positions
[2, 4], where ``lax.top_k`` returns [1, 2]), so every top-k of the port
goes through :func:`topk_positions`, which imposes the reference's order
explicitly.
"""
from __future__ import annotations

import torch

from repro_torch.core import bigvec

HIST_BINS = 2048
_HIST_CHUNK = 1 << 24    # elements per chunk of linear_histogram


def topk_positions(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Positions (int64) of the k largest keys, ordered by (key desc,
    position asc) exactly as ``lax.top_k``.

    torch.topk only supplies the k-th largest VALUE, which is unique
    whatever its tie order. Every position with a larger key is taken,
    then the lowest positions holding the k-th key fill the rest; a
    stable descending sort of those k keys keeps ties in position order
    (equal keys are either all above the k-th or all equal to it, and
    each group is already ascending). Memory stays O(J) booleans + O(k),
    so it also serves the dense exact fallback at full J.

    fp32 keys are ranked by their bit patterns: for the keys the port
    ranks (|x| >= 0, NaN from |x|, and -inf for a disabled slot) that is
    the order of the values, with NaN above +inf as ``lax.top_k`` ranks
    it (a float comparison would drop NaN from the selection).

    Keys of more than one dimension are ranked along the last one, row
    by row, by one stable descending sort of the bit patterns: (key
    desc, position asc) too. That serves short rows (a router's
    experts), where a sort costs little and no row waits on the host."""
    if keys.dim() > 1:
        bits = keys.view(torch.int32) if keys.dtype == torch.float32 \
            else keys
        order = torch.sort(bits, dim=-1, descending=True, stable=True)
        return order.indices[..., :k]
    k = int(min(k, keys.numel()))
    if keys.dtype == torch.float32:
        keys = keys.view(torch.int32)
    kth = torch.topk(keys, k, sorted=False).values.min()
    above = torch.nonzero(keys > kth).squeeze(1)
    ties = torch.nonzero(keys == kth).squeeze(1)[: k - above.numel()]
    sel = torch.cat([above, ties])
    order = torch.sort(keys[sel], descending=True, stable=True).indices
    return sel[order]


def topk_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k indices (int64) by |score|, in lax.top_k order."""
    return topk_positions(score.float().abs(), k)


def randk_indices(key: torch.Tensor, j: int, k: int) -> torch.Tensor:
    """A uniform random k-subset of [0, j) as the reference draws it: the
    top-k positions (int64, lax.top_k order) of j uint32 draws of
    ``jax.random.bits(key, (j,), uint32)``. The draws are generated in
    chunks into int32 keys u - 2^31, which order as the uint32 words
    do, so the stream's memory is 4 bytes an element."""
    from repro_torch.core import threefry
    keys = torch.empty(j, dtype=torch.int32, device=key.device)
    for lo in range(0, j, _HIST_CHUNK):
        hi = min(j, lo + _HIST_CHUNK)
        keys[lo:hi] = threefry.random_bits32_range(key, lo, hi) - (1 << 31)
    return topk_positions(keys, int(min(k, j)))


def hist_tail_bin(hist: torch.Tensor, target) -> torch.Tensor:
    """Largest bin index b whose tail count (entries in bins >= b) is
    >= target; -1 if none. ``target`` may be a device tensor."""
    bins = hist.shape[0]
    tail = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    ok = tail >= target
    ar = torch.arange(bins, device=hist.device)
    return torch.where(ok, ar, torch.full_like(ar, -1)).max()


def topk_mask_exact(score: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 mask (score's dtype) of the k largest-|score| entries."""
    idx = topk_indices(score, k)
    return bigvec.mask_from_indices(score.numel(), idx, score.dtype)


def linear_histogram(x: torch.Tensor, amax: torch.Tensor,
                     bins: int = HIST_BINS) -> torch.Tensor:
    """(bins,) int32 counts of clip(trunc(|x| / amax * bins), 0, bins-1)
    for a 0-d fp32 amax, a NaN counted in bin 0 (as XLA converts it).
    One IEEE division and an exact multiply per entry, as the reference's
    compiled program bins; for a bf16 x the quotient is rounded to bf16
    (the reference divides in x's dtype). Chunked over x, so it runs at
    full J."""
    hist = torch.zeros(bins, dtype=torch.int64, device=x.device)
    j = x.numel()
    for lo in range(0, j, _HIST_CHUNK):
        q = x[lo:lo + _HIST_CHUNK].float().abs() / amax
        if x.dtype == torch.bfloat16:
            q = q.to(torch.bfloat16).float()
        q = q * bins
        b = q.clamp_(max=bins - 1).nan_to_num_(nan=0.0).long()
        hist += torch.bincount(b, minlength=bins)
    return hist.to(torch.int32)


def histogram_threshold(score: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest |score| estimated at a linear-histogram bin edge
    (plain tensor ops): count(|score| >= tau) >= k. amax = max|score|,
    taken as 1.0 when it is not > 0 (the reference's rule; the kernel's
    op floors it at 1e-30 instead). A bf16 score is binned and its tau
    formed in bf16 operations, each rounded, as the reference's compiled
    program computes them: b rounded to bf16, b / bins * amax rounded."""
    amax = score.float().abs().amax()
    amax = torch.where(amax > 0, amax, torch.ones_like(amax))
    hist = linear_histogram(score, amax)
    b = hist_tail_bin(hist, k)
    if score.dtype == torch.bfloat16:
        tau = (b.to(torch.bfloat16).float() / HIST_BINS * amax).to(
            torch.bfloat16)
    else:
        tau = b.to(torch.float32) / HIST_BINS * amax
    return torch.where(b >= 0, tau, torch.zeros_like(tau))


def topk_mask_histogram(score: torch.Tensor, k: int,
                        use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        from repro_torch.kernels.topk_select.ops import histogram_threshold_op
        tau = histogram_threshold_op(score, k)
    else:
        tau = histogram_threshold(score, k)
    return (score.abs() >= tau).to(score.dtype)


def topk_mask(score: torch.Tensor, k: int,
              method: str = "exact") -> torch.Tensor:
    if method == "exact":
        return topk_mask_exact(score, k)
    if method == "histogram":
        return topk_mask_histogram(score, k)
    if method == "histogram_kernel":
        return topk_mask_histogram(score, k, use_kernel=True)
    raise ValueError(f"unknown selector {method!r}")
