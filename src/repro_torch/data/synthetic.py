"""Deterministic synthetic data (the port of ``repro.data.synthetic``).

- ``lm_batch``: LM batches with the reference's shapes and next-token
  target shift, drawn from a ``torch.Generator`` seeded by (seed, step).
  The token values differ from the reference's JAX stream; tests that
  compare the two packages make their batches with numpy.
- ``linreg_dataset``: the paper's §4.1 Gaussian linear-model datasets
  (per-worker ground truth t_n ~ N(u_n, h^2), u_n ~ N(U, sigma^2)) and
  the global least-squares optimum w*.
- ``image_dataset``: the synthetic 10-class image set that stands in for
  CIFAR-10 in the §4.2 experiment (class-conditional Gaussian means).

The last two draw from numpy's ``default_rng`` with the reference's calls
in the reference's order, so both packages hold the same arrays bit for
bit; they come back as fp32 tensors (labels int64) on the given device,
as ``jnp.asarray`` returns them with x64 off.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import resolve_device


def lm_batch(cfg, batch: int, seq: int, seed: int, step: int,
             device) -> dict:
    """tokens (B, S) int64 uniform over the vocab; targets = tokens
    shifted left by one, -1 (masked) in the last position."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) << 32) + int(step))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=device)
    targets = torch.cat([tokens[:, 1:],
                         torch.full((batch, 1), -1, device=device,
                                    dtype=tokens.dtype)], 1)
    return {"tokens": tokens, "targets": targets}


def _f32(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(dev)


def linreg_dataset(n_workers=20, n_points=500, dim=100, U=0.0, sigma2=5.0,
                   h2=1.0, noise=0.5, seed=0, device=None):
    """Per-worker (X, y) and the global LS optimum w* of (1/N) sum_n
    ||X_n w - y_n||^2 / (2 D_n), solved in float64, then cast to fp32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(n_workers):
        u_n = rng.normal(U, np.sqrt(sigma2))
        t_n = rng.normal(u_n, np.sqrt(h2), size=(dim,))
        X = rng.normal(0.0, 1.0, size=(n_points, dim))
        eps = rng.normal(0.0, np.sqrt(noise), size=(n_points,))
        xs.append(X)
        ys.append(X @ t_n + eps)
    A = sum(x.T @ x for x in xs)
    b = sum(x.T @ y for x, y in zip(xs, ys))
    w_star = np.linalg.solve(A, b)
    return ([_f32(x, dev) for x in xs], [_f32(y, dev) for y in ys],
            _f32(w_star, dev))


def image_dataset(n_train=2000, n_test=500, n_classes=10, hw=16, seed=0,
                  device=None):
    """Class-conditional Gaussian images (B, hw, hw, 3), NHWC as in the
    reference, and int64 labels: (x_train, y_train, x_test, y_test)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 1.0, size=(n_classes, hw, hw, 3)).astype(
        np.float32)

    def make(n, s):
        r = np.random.default_rng(s)
        y = r.integers(0, n_classes, size=(n,))
        x = means[y] + r.normal(0.0, 1.5, size=(n, hw, hw, 3)).astype(
            np.float32)
        return _f32(x, dev), torch.from_numpy(y.astype(np.int64)).to(dev)

    xtr, ytr = make(n_train, seed + 1)
    xte, yte = make(n_test, seed + 2)
    return xtr, ytr, xte, yte
