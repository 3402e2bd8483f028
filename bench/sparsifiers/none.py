"""Dense SGD keeps no compressor state."""
from __future__ import annotations


def first_dense_gradient(ef: dict):
    return None
