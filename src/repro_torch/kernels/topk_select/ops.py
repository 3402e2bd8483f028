"""Threshold top-k selection through the histogram kernel (the port of
``repro.kernels.topk_select.ops``, with ``threshold_from_hist`` from its
``ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.select import hist_tail_bin
from repro_torch.kernels.topk_select import kernel


def threshold_from_hist(hist, amax, k: int, dtype=torch.float32):
    """Smallest bin boundary tau with count(|x| >= tau) >= k: the lower
    edge b / bins * amax of the largest bin b whose tail count reaches
    k, or 0.0 when none does."""
    b = hist_tail_bin(hist, k)
    tau = b.to(torch.float32) / hist.numel() * amax
    return torch.where(b >= 0, tau, torch.zeros_like(tau)).to(dtype)


def abs_max(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a 0-d tensor, NaN if any x is NaN: the inf-norm, which
    equals ``x.abs().amax()`` bit for bit without writing |x| out first
    (a J-sized temporary: 3.57 GB at J = 892,032,000)."""
    return torch.linalg.vector_norm(x, float("inf"))


def histogram_threshold_op(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th |x| magnitude through the histogram kernel; x (J,) any float.
    amax is a plain reduction outside the kernel, as in the reference."""
    xf = x.float().contiguous()
    amax = abs_max(xf)
    hist = kernel.histogram(xf, amax)
    return threshold_from_hist(hist, amax, k, x.dtype)


def topk_mask_op(x: torch.Tensor, k: int) -> torch.Tensor:
    tau = histogram_threshold_op(x, k)
    return (x.abs() >= tau).to(x.dtype)
