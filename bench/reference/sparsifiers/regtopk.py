"""The plain reference of REGTOP-k (the paper's Algorithm 1) for one
worker: the score, the exact top-k selection, the error feedback and the
posterior it keeps for the next step; and the mean combine of the
workers' sparse payloads. Float32 throughout. Imports nothing but torch.

    a^t     = eps^t + g^t
    Delta^t = (g_agg^{t-1} - w a^{t-1}) / (w a^t)  on last step's support
    key     = |a^t| tanh(|1 + Q| / mu)                  off the support
            = |a^t tanh(|1 + Delta^t| / mu)|            on it
    s^t     = Top_k(key)     (plain TOP-k of |a| at t = 0)
    ghat    = s^t a^t,  eps^{t+1} = a^t - ghat
"""
from __future__ import annotations

import math

import torch

TINY = 1e-12
# the traffic's sparsifier keys this reference follows (None: any value).
# The fused and reference pipelines, and sparse or dense communication,
# compute the same selection and aggregate; buckets, a bf16 state or
# wire and the histogram selectors compute others, which this reference
# does not model.
HONOURS = {"kind": ("regtopk",), "sparsity": None, "mu": None, "Q": None,
           "pipeline": ("fused", "reference"),
           "comm_mode": ("sparse", "dense"), "selector": ("exact",),
           "num_buckets": (1,), "ef_dtype": ("float32",),
           "wire_dtype": ("float32",)}


def resolve_k(sparsity: float, j: int) -> int:
    return max(1, int(round(sparsity * j)))


class Worker:
    """One worker's REGTOP-k state over a J-length gradient; ``sp`` the
    traffic's sparsifier, ``omega`` the worker's weight in the mean."""

    def __init__(self, j: int, sp: dict, omega: float, device):
        self.k = resolve_k(sp["sparsity"], j)
        self.omega, self.mu, self.Q = omega, sp["mu"], sp["Q"]
        self.err = torch.zeros(j, device=device)
        self.step = 0
        self.idx = None          # last step's support (int64)
        self.a_sel = None        # a^{t-1} at it
        self.g_sel = None        # g_agg^{t-1} at it

    def keys(self, a: torch.Tensor) -> torch.Tensor:
        if self.step == 0:
            return a.abs()
        c = math.tanh(abs(1.0 + self.Q) / self.mu)
        key = (a * c).abs()
        a_s = a[self.idx]
        den = self.omega * a_s
        den = torch.where(den.abs() > TINY, den,
                          torch.sign(den) * TINY + TINY)
        delta = (self.g_sel - self.omega * self.a_sel) / den
        key[self.idx] = (a_s * torch.tanh((1.0 + delta).abs()
                                          / self.mu)).abs()
        return key

    def compress(self, g: torch.Tensor) -> tuple:
        """(indices, values) of this step's k entries; the error state
        keeps the rest."""
        a = self.err.add_(g)              # the state's buffer becomes a
        idx = torch.topk(self.keys(a), self.k, sorted=False).indices
        values = a[idx].clone()
        a[idx] = 0.0                      # eps^{t+1}
        self.idx, self.a_sel = idx, values
        return idx, values

    def observe(self, g_agg: torch.Tensor) -> None:
        self.g_sel = g_agg[self.idx].clone()
        self.step += 1


def combine(payloads: list, j: int, device) -> torch.Tensor:
    """The mean over the workers of their scattered payloads."""
    out = torch.zeros(j, device=device)
    for idx, values in payloads:
        out.index_add_(0, idx, values)
    return out.mul_(1.0 / len(payloads))
