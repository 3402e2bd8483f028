"""Threefry-2x32, the counter-based generator behind the reference's PRNG
keys, on torch tensors (the port draws the same numbers as
``jax.random`` with its default threefry key implementation).

Words are uint32 values held in int64 tensors and masked to 32 bits
after every add and shift, because torch has no full uint32 arithmetic.
Everything runs on the tensors' device with no host read, so a 0-d step
counter on the card yields a 0-d draw on the card.

The draws follow jax's partitionable layout
(``jax_threefry_partitionable=True``, the default since jax 0.5): the
32 random bits at flat position i of a draw are the XOR of the two
output words of threefry(key, (i >> 32, i & 0xFFFFFFFF)), so a 0-d draw
is threefry(key, (0, 0)), and ``split(key, n)[i]`` is threefry(key, (0,
i)). The older layout gives other words.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _word(x, device=None) -> torch.Tensor:
    """A uint32 word (int or tensor) as an int64 tensor masked to 32 bits;
    an int is filled in on the device (no copy from the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.full((), int(x) & MASK, dtype=torch.int64, device=device)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds of key (k0, k1) on the counter words
    (x0, x1), uint32 values in int64 tensors (broadcast together).
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the (2,) key (seed >> 32, seed &
    0xFFFFFFFF) of an integer seed, int64 words."""
    seed = int(seed)
    hi = (seed >> 32) & MASK if seed >= 0 else 0
    return torch.stack([_word(hi, device), _word(seed, device)])


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry(key, (0, data)) for a
    0-d data word (an int or a 0-d integer tensor on key's device)."""
    d = _word(data, key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([y0, y1])


def random_bits32(key: torch.Tensor) -> torch.Tensor:
    """The 32 random bits of a 0-d ``jax.random.bits(key)`` in the
    partitionable layout: the XOR of threefry(key, (0, 0))'s two words."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], zero, zero)
    return y0 ^ y1


def random_bits32_range(key: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Positions [lo, hi) of ``jax.random.bits(key, (j,), uint32)`` (any
    j >= hi), int64 values in [0, 2^32), on key's device: a caller can
    draw a long stream in chunks of bounded memory."""
    i = torch.arange(lo, hi, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], i >> 32, i & MASK)
    return y0 ^ y1


def uniform01(key: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 ``jax.random.uniform(key)`` in [0, 1): the top 23 bits
    as the mantissa of a float in [1, 2), minus 1 (exact)."""
    bits = (random_bits32(key) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def mul_u32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 of uint32 words in int64 tensors (or an int b),
    exact: a 32x32-bit product overflows int64, so it is taken in 16-bit
    halves, (al*bl + ((ah*bl + al*bh) mod 2^16) * 2^16) mod 2^32."""
    b = _word(b, a.device)
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    return (al * bl + (((ah * bl + al * bh) & 0xFFFF) << 16)) & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` in the partitionable layout: the
    (num, 2) keys threefry(key, (0, i)) for i in [0, num)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], 1)


def randint(key: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """A 0-d int32 ``jax.random.randint(key, (), minval, maxval)`` for
    int32 bounds: jax's own reduction, two 32-bit draws from the keys of
    ``split(key)`` combined as (hi mod span) * (2^32 mod span) + (lo mod
    span), mod span, with span = maxval - minval (1 when maxval <=
    minval) and every product taken mod 2^32, as jax's uint32 arithmetic
    does."""
    keys = split(key)
    hi, lo = random_bits32(keys[0]), random_bits32(keys[1])
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    off = (mul_u32(hi % span, mult) + lo % span) & MASK
    out = (minval + off % span) & MASK
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(torch.int32)
