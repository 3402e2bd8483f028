"""Top-k selection over flat score vectors (the port's ``repro.core.select``).

The reference's exact selector is ``lax.top_k``: keys descending, ties
broken by position ascending. ``torch.topk`` orders ties in no stated
way (on torch 2.13's CPU build ``topk([1,3,3,2,3], 2)`` returns positions
[2, 4], where ``lax.top_k`` returns [1, 2]), so every top-k of the port
goes through :func:`topk_positions`, which imposes the reference's order
explicitly.
"""
from __future__ import annotations

import torch


def topk_positions(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Positions (int64) of the k largest keys, ordered by (key desc,
    position asc) exactly as ``lax.top_k``.

    torch.topk only supplies the k-th largest VALUE, which is unique
    whatever its tie order. Every position with a larger key is taken,
    then the lowest positions holding the k-th key fill the rest; a
    stable descending sort of those k keys keeps ties in position order
    (equal keys are either all above the k-th or all equal to it, and
    each group is already ascending). Memory stays O(J) booleans + O(k),
    so it also serves the dense exact fallback at full J."""
    k = int(min(k, keys.numel()))
    kth = torch.topk(keys, k, sorted=False).values.min()
    above = torch.nonzero(keys > kth).squeeze(1)
    ties = torch.nonzero(keys == kth).squeeze(1)[: k - above.numel()]
    sel = torch.cat([above, ties])
    order = torch.sort(keys[sel], descending=True, stable=True).indices
    return sel[order]


def topk_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k indices (int64) by |score|, in lax.top_k order."""
    return topk_positions(score.float().abs(), k)


def hist_tail_bin(hist: torch.Tensor, target) -> torch.Tensor:
    """Largest bin index b whose tail count (entries in bins >= b) is
    >= target; -1 if none. ``target`` may be a device tensor."""
    bins = hist.shape[0]
    tail = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    ok = tail >= target
    ar = torch.arange(bins, device=hist.device)
    return torch.where(ok, ar, torch.full_like(ar, -1)).max()
