"""The linear magnitude histogram of threshold top-k selection for
Hopper and its plain PyTorch version (the port of
``repro.kernels.topk_select.kernel``).

:func:`histogram` (kernel ``csrc/hist.cu``) counts every |x| into 2048
linear bins of [0, max(amax, 1e-30)]: bin = clip(trunc(|x| / amax' *
2048), 0, 2047), a NaN in bin 0. It dispatches on the tensors' device:
a CPU tensor runs the plain version, a CUDA tensor launches the kernel
(or raises). ``histogram.launches`` counts kernel launches. Any J is
served without padding, so no bin-0 correction is needed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.numerics import f32
from repro_torch.core.select import HIST_BINS, linear_histogram
from repro_torch.kernels.common import (aligned, check_launch, check_vec,
                                        grid, lib, on_card, same_device,
                                        stream)

BINS = HIST_BINS
BLOCK = 4096                 # elements per tile of the kernel
CTAS_PER_SM = 3              # 64 KB of shared memory each (8 sub-histograms)
AMAX_FLOOR = f32(1e-30)      # the reference's max(amax, 1e-30)


def histogram_plain(x, amax):
    return linear_histogram(x, amax.reshape(()).clamp(min=AMAX_FLOOR))


def histogram(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """(2048,) int32 histogram of |x| for x (J,) fp32 and amax a
    one-element fp32 tensor on x's device (read by the kernel there, so
    no host sync)."""
    check_vec("x", x)
    check_vec("amax", amax.reshape(-1), 1)
    same_device("histogram", x, amax)
    if not on_card(x):
        return histogram_plain(x, amax)
    hist = torch.zeros(BINS, dtype=torch.int32, device=x.device)
    fn = lib("hist").hist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    j = x.numel()
    check_launch("histogram", fn(
        x.data_ptr(), amax.data_ptr(), hist.data_ptr(), j,
        grid(x.device, -(-j // BLOCK), CTAS_PER_SM), aligned(x),
        stream(x.device)))
    histogram.launches += 1
    return hist


histogram.launches = 0
# byte contract at length j: x read once, the 2048 counts written once
histogram.bytes_moved = lambda j: 4 * j + 4 * BINS
KERNELS = (histogram,)
