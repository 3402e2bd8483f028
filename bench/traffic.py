"""The one generator of the benchmark's traffic: a training job read from
a traffic file (``bench/traffic/<name>.json``) and its batches.

A traffic file gives the rows a rank and a step, the sequence length,
the data-parallel ranks, the sparsifier and the optimizer. The loop is
closed: each step starts when the last has ended, as synchronous data
parallelism runs. The window draws its batches with the program's own
``repro_torch.data.lm_batch``; :func:`batch` is the benchmark's
independent copy of that draw, which makes the reference's inputs, so a
drift between the two shows as ``correct`` false: tokens uniform over
the vocabulary from a generator on the card seeded by (seed, step),
targets the tokens shifted left with the last position masked (-1).
"""
from __future__ import annotations

import torch

KEYS = ("name", "batch_per_rank", "seq", "ranks", "sparsifier",
        "optimizer")


def check(job: dict, name: str) -> None:
    """Raise ValueError for a traffic file the generator cannot run."""
    if sorted(job) != sorted(KEYS):
        raise ValueError(f"traffic {name}: keys {sorted(job)}, not "
                         f"{sorted(KEYS)}")
    if job["name"] != name:
        raise ValueError(f"traffic file {name} names itself {job['name']!r}")
    for key in ("batch_per_rank", "seq", "ranks"):
        if not (isinstance(job[key], int) and job[key] > 0):
            raise ValueError(f"traffic {name}: {key} must be a positive "
                             "whole number")


def check_honoured(part: dict, honours: dict, what: str) -> None:
    """Raise ValueError where the traffic's ``part`` (its sparsifier or
    its optimizer) holds a key or a value that the reference does not
    follow: ``honours`` maps each key it follows to the values it
    follows, or to None for any."""
    for key, value in part.items():
        if key not in honours:
            raise ValueError(f"{what} {key}: the reference does not "
                             "follow it")
        if honours[key] is not None and value not in honours[key]:
            raise ValueError(f"{what} {key} {value!r}: the reference "
                             f"follows {honours[key]}")


def batch(vocab: int, rows: int, seq: int, seed: int, step: int,
          device) -> tuple:
    """(tokens, targets), each (rows, seq) int64, of step ``step``."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) << 32) + int(step))
    tokens = torch.randint(0, vocab, (rows, seq), generator=gen,
                           device=device)
    targets = torch.cat([tokens[:, 1:],
                         torch.full((rows, 1), -1, device=device,
                                    dtype=tokens.dtype)], 1)
    return tokens, targets


def data_seed(seed: int) -> int:
    """The 31-bit seed of the batches for a run's ``--seed`` (any whole
    number): (seed << 32) + step must fit a generator's 64 bits."""
    return int(seed) % (2 ** 31 - 1)


def weight_seed(seed: int) -> int:
    """The seed of the weights for a run's ``--seed``, a stream apart
    from the batches'."""
    return (int(seed) * 2654435761 + 97) % (2 ** 63 - 1)
