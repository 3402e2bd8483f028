"""Deterministic synthetic LM batches (the port of
``repro.data.synthetic.lm_batch``): the same shapes and the same
next-token target shift, drawn from a ``torch.Generator`` seeded by
(seed, step). The token values differ from the reference's JAX stream;
tests that compare the two packages make their batches with numpy.
"""
from __future__ import annotations

import torch


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
