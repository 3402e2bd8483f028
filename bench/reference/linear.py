"""The reference's linear layers in the precision a run asks for.

``mode`` "fp32" is the reference: float32 with TF32 off everywhere.
"fp8" is the control: each linear layer's operands rounded to float8
e4m3 with a per-tensor scale and its output's gradient to e5m2, as an
fp8 training recipe does; everything else stays float32. Imports
nothing but torch.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
MODES = ("fp32", "fp8")


def exact_matmuls() -> None:
    """Float32 products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 format under a per-tensor scale, back in fp32."""
    scale = top / x.abs().amax().float().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq = _fp8(x, torch.float8_e4m3fn, E4M3_MAX)
        wq = _fp8(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = _fp8(gy, torch.float8_e5m2, E5M2_MAX)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fp32":
        return x @ w
    if mode == "fp8":
        return _Fp8Linear.apply(x, w)
    raise ValueError(f"unknown precision mode {mode!r} {MODES}")
