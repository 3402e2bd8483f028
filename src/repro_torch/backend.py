"""Device selection for the port's entry points.

Counterpart of the reference's ``kernels/common.auto_interpret`` and
``kernels/compress/ops.default_strategy``: there the backend picks native
Pallas on a TPU and an XLA lowering elsewhere. Here the device is explicit.
``None`` means the CUDA card and raises when there is none; the CPU is
used only when the caller asks for it by name. Nothing falls back to the
CPU silently.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda[:i]"``/``torch.device`` as
    given, and ``"meta"``, on which the dry run traces a step without
    memory (``launch.dryrun``). Raises RuntimeError naming the missing
    device when a CUDA device is requested (explicitly or by default)
    and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise RuntimeError(f"unsupported device {str(dev)!r} "
                           "(cuda | cpu | meta)")
    return dev


def configure_numerics() -> None:
    """fp32 matmuls and convolutions in full fp32 on the card (no TF32),
    as the reference's XLA programs compute them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
