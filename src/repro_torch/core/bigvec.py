"""Index conventions for flat vectors (the port's ``repro.core.bigvec``).

The reference carries selection indices as uint32, because J may exceed
the int32 range. torch's uint32 support is partial (no sort, no
searchsorted), so the port computes with int64 and carries indices as
4-byte values on the wire and in the state: an int32 tensor holding the
uint32 bits, so a (value, index) pair stays 8 bytes as in the reference.
The uint32 sentinel 0xFFFFFFFF (an empty candidate slot) maps to
4294967295 in int64 and to -1 in the int32 view.
"""
from __future__ import annotations

import torch

U32_SPAN = 1 << 32
INVALID_IDX = 0xFFFFFFFF


def as_index(idx: torch.Tensor) -> torch.Tensor:
    """int64 index tensor from int64 or an int32 view of uint32 bits."""
    if idx.dtype == torch.int32:
        return idx.to(torch.int64) & 0xFFFFFFFF
    if idx.dtype != torch.int64:
        raise TypeError(f"index dtype {idx.dtype} (int32 bits | int64)")
    return idx


def to_u32_bits(idx: torch.Tensor) -> torch.Tensor:
    """int64 indices in [0, 2^32) -> int32 tensor holding the uint32 bits."""
    return torch.where(idx >= (1 << 31), idx - U32_SPAN, idx).to(torch.int32)


def gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return a[as_index(idx)]


def scatter_set_(a: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """In place ``a[idx] = vals``; indices must be distinct unless every
    duplicate writes the same value."""
    idx = as_index(idx)
    if isinstance(vals, torch.Tensor):
        return a.index_put_((idx,), vals)
    return a.index_fill_(0, idx, vals)


def live_idx(idx: torch.Tensor, live, j: int) -> torch.Tensor:
    """int64 indices with the non-live slots of ``idx`` routed out of
    range, to the sentinel ``j`` (the reference's ``live_idx``). A
    scatter into a (j + 1,) buffer then drops them into its last
    element, which the caller cuts off (``[:j]``): no host read of
    ``live``."""
    return torch.where(live, as_index(idx), j)


def scatter_set_live_(a: torch.Tensor, idx: torch.Tensor, live,
                      val) -> torch.Tensor:
    """In place ``a[idx] = val`` (a scalar, or one value a slot) at the
    live slots of ``idx`` (every slot when ``live`` is None; ``live`` 0-d
    or one bit a slot); the reference's scatter through ``live_idx``
    with ``mode="drop"``, on a buffer of exactly J and with no host read
    of ``live``. Live indices must be distinct. A dead slot writes, at
    the first live slot's index, what that slot writes (or, with none
    live, the value there back), so a dead slot that aliases a live
    index (the histogram selector's pads at index 0) cannot undo its
    write."""
    if live is None:
        return scatter_set_(a, idx, val)
    idx = as_index(idx)
    live = live.expand(idx.shape)
    new = torch.where(live, val, a[idx])
    first = torch.argmax(live.to(torch.int32))    # 0 when none is live
    return a.index_put_((torch.where(live, idx, idx[first]),),
                        torch.where(live, new, new[first]))


def scatter_add_(a: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """In place ``a[idx] += vals``."""
    return a.index_add_(0, as_index(idx), vals)


def mask_from_indices(j: int, idx: torch.Tensor, dtype=torch.float32,
                      live=None) -> torch.Tensor:
    """(j,) 0/1 mask with ones at idx, on idx's device; with ``live``
    (bool, idx's shape or 0-d) only at the live slots."""
    if live is None:
        mask = torch.zeros(j, dtype=dtype, device=idx.device)
        return mask.index_fill_(0, as_index(idx), 1)
    mask = torch.zeros(j + 1, dtype=dtype, device=idx.device)
    return mask.index_fill_(0, live_idx(idx, live, j), 1)[:j]
