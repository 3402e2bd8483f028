"""The benchmark's frozen yardsticks: the H100's peaks, the byte counts of
the two sweep kernels (B1 and B2) and the model FLOPs of a training step.

They are copies, kept here so that a change to the program cannot move
the ruler it is measured with. The byte counts count each input read
once and each output written once, whatever implements the kernel; the
FLOP count is the model's, with nothing recomputed.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# the sweeps' tiling: elements a tile and bins of the |score| histogram
SWEEP_BLOCK = 4096
SWEEP_BINS = 2048


def sweep_rows(j: int) -> int:
    """Tiles of a sweep over j elements."""
    return -(-j // SWEEP_BLOCK)


def sweep1_bytes(j: int, state_bytes: int = 4) -> int:
    """B1, plain mode: reads g (fp32) and the error state, writes a and
    the score (fp32), each tile's amax and the 2048-bin histogram."""
    return ((4 + state_bytes + 8) * j + 4 * sweep_rows(j)
            + 4 * SWEEP_BINS)


def sweep2_slots(j: int, k: int) -> int:
    """B2's candidate slots a tile: about 8 times the mean selection
    density, at least 32, at most a whole tile."""
    return int(min(SWEEP_BLOCK, max(32, -(-8 * k * SWEEP_BLOCK // j))))


def sweep2_bytes(j: int, k: int) -> int:
    """B2: reads the score, writes each tile's slots (a value and an
    index each) and its count."""
    rows = sweep_rows(j)
    return 4 * j + 8 * rows * sweep2_slots(j, k) + 4 * rows


def matmul_params(cfg: dict) -> int:
    """Parameters that take part in a matrix product: the attention's
    four projections and the SwiGLU MLP of every layer, and the output
    head; the token table's lookup is no product."""
    d, dff = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    layer = attn + 3 * d * dff
    return cfg["num_hidden_layers"] * layer + d * cfg["vocab_size"]


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """6 x the matmul parameters plus the attention term 12 L d seq."""
    return (6.0 * matmul_params(cfg)
            + 12.0 * cfg["num_hidden_layers"] * cfg["hidden_size"] * seq)


def mfu_pct(cfg: dict, seq: int, tokens_per_s: float, cards: int) -> float:
    """Model FLOPs a second over the cards' bf16 dense peak, in %."""
    return (100.0 * train_flops_per_token(cfg, seq) * tokens_per_s
            / (BF16_FLOPS_PER_S * cards))


def roofline_pct(n_bytes: float, seconds: float) -> float:
    """The least time the bytes take at the HBM rate over the time taken,
    in %."""
    return 100.0 * n_bytes / HBM_BYTES_PER_S / seconds
