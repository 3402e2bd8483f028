"""The plain reference of Adam over one flat fp32 parameter vector.
Imports nothing but torch."""
from __future__ import annotations

import torch

# the traffic's optimizer keys this reference follows (None: any value)
HONOURS = {"kind": ("adam",), "lr": None, "b1": None, "b2": None,
           "eps": None}


class Optimizer:
    """Adam; ``opt`` the traffic's optimizer."""

    def __init__(self, params: torch.Tensor, opt: dict):
        self.p, self.lr = params, opt["lr"]
        self.b1, self.b2, self.eps = opt["b1"], opt["b2"], opt["eps"]
        self.m = torch.zeros_like(params)
        self.v = torch.zeros_like(params)
        self.t = 0

    def step(self, g: torch.Tensor) -> None:
        """p -= lr m_hat / (sqrt(v_hat) + eps), in place."""
        self.t += 1
        self.m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        self.v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        mhat = self.m / (1.0 - self.b1 ** self.t)
        den = (self.v / (1.0 - self.b2 ** self.t)).sqrt_().add_(self.eps)
        self.p.addcdiv_(mhat, den, value=-self.lr)
