"""PyTorch + CUDA port of the REGTOP-k sparsified-training system.

A package of its own beside the JAX reference (``src/repro``). It imports
``torch`` and never ``jax``, and nothing of the JAX package: what it needs
of the reference's pure-Python parts (configs, numeric conventions) it
keeps as its own copy. Module names mirror the reference so each
counterpart is easy to find.

Every entry point takes ``device=None``, which means the CUDA card; with
no card present it raises. The CPU runs only when the caller passes
``device="cpu"`` (the CPU tests do), and there every hand-written kernel
is replaced by its plain PyTorch version, chosen by the tensor's device.
"""
from repro_torch.backend import resolve_device

__all__ = ["resolve_device"]
