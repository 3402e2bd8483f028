"""The plain reference of dense SGD's exchange (``kind="none"``): each
worker sends its whole gradient and the aggregate is their mean. Imports
nothing but torch."""
from __future__ import annotations

import torch

HONOURS = {"kind": ("none",), "comm_mode": ("sparse", "dense", "simulate")}


class Worker:
    def __init__(self, j: int, sp: dict, omega: float, device):
        pass

    def compress(self, g: torch.Tensor) -> torch.Tensor:
        return g

    def observe(self, g_agg: torch.Tensor) -> None:
        pass


def combine(payloads: list, j: int, device) -> torch.Tensor:
    """The mean of the workers' gradients."""
    out = torch.zeros(j, device=device)
    for g in payloads:
        out.add_(g)
    return out.mul_(1.0 / len(payloads))
