"""What every kernel wrapper of the port shares: the choice between the
kernel and its plain version by the tensors' device, the input checks,
the launch geometry and the library loader.

A CPU tensor runs the plain PyTorch version, a CUDA tensor launches the
kernel (or raises); any other device raises. There is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes

import torch


def on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no sweep for device {x.device} (cuda | cpu)")


def check_vec(name, x, n=None, dtype=torch.float32):
    if x.dtype != dtype or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D {dtype} tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if n is not None and x.numel() != n:
        raise ValueError(f"{name}: expected {n} elements, got {x.numel()}")


def same_device(name, *xs) -> None:
    if len({x.device for x in xs}) != 1:
        raise ValueError(f"{name}: all tensors must share a device")


def grid(dev: torch.device, units: int, per_sm: int = 4) -> int:
    """Persistent grid: at most ``per_sm`` CTAs per SM, no more than the
    work units (tiles) there are."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(units, per_sm * sms))


def aligned(*xs) -> int:
    """1 when every tensor's data is 16-byte aligned (float4 access)."""
    return int(all(x.data_ptr() % 16 == 0 for x in xs))


def stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def lib(name: str):
    from repro_torch.kernels import build
    return build.load(name)


def check_launch(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")
