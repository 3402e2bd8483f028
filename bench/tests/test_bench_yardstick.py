"""The frozen yardsticks against the program's own byte counts today and
against counts by hand."""
import json

import pytest

from bench import weights, yardstick
from bench.families import dense
from bench.tests.conftest import ROOT

# a Llama-layout dense decoder at Granite-8B-code's widths and 3 layers:
# grouped key/value heads in the counts
GQA = dict(name="gqa.l3", source="test", family="dense", hidden_size=4096,
           intermediate_size=14336, num_attention_heads=32,
           num_key_value_heads=8, num_hidden_layers=3, vocab_size=49152,
           partial_rotary_factor=1.0, rope_theta=10000.0, norm="rmsnorm",
           rms_norm_eps=1e-5, hidden_act="silu", use_qkv_bias=False,
           tie_word_embeddings=False, torch_dtype="bfloat16")


def _config(name):
    if name == GQA["name"]:
        return GQA
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("j", [1, 4095, 4096, 4097, 2 ** 22 + 3,
                               892_032_000, 1_056_993_280])
def test_sweep1_bytes_equal_the_programs(j):
    from repro_torch.kernels.compress import kernel
    assert yardstick.sweep1_bytes(j) == kernel.sweep1.bytes_moved(j)
    assert yardstick.sweep1_bytes(j, 2) == kernel.sweep1_bf16.bytes_moved(j)


@pytest.mark.parametrize("j,k", [(4096, 1), (100_000, 100), (2 ** 22, 4194),
                                 (892_032_000, 892_032),
                                 (1_056_993_280, 1_056_993)])
def test_sweep2_bytes_equal_the_programs(j, k):
    from repro_torch.kernels.compress import kernel, ops
    assert yardstick.sweep2_slots(j, k) == ops.maxpb_for(k, j)
    assert yardstick.sweep2_bytes(j, k) == kernel.sweep2.bytes_moved(
        j, ops.maxpb_for(k, j))


def test_sweep_bytes_by_hand():
    # J = 892,032,000: 217,782 tiles (the last one part-filled); g, the
    # state, a and the score at 4 bytes an element
    j, rows = 892_032_000, 217_782
    assert yardstick.sweep_rows(j) == rows
    assert yardstick.sweep1_bytes(j) == 16 * j + 4 * rows + 4 * 2048
    # k = 892,032: 8 k 4096 / J = 32.77 -> 33 slots a tile
    assert yardstick.sweep2_slots(j, 892_032) == 33
    assert yardstick.sweep2_bytes(j, 892_032) == 4 * j + 8 * rows * 33 \
        + 4 * rows


@pytest.mark.parametrize("name,j,matmul", [
    # 8 x (4 x 2560^2 + 3 x 2560 x 6912) + 2560 x 50304
    ("stablelm-3b-4e1t.l8", 892_032_000, 763_166_720),
    # 3 x (2 x 4096^2 + 2 x 4096 x 1024 + 3 x 4096 x 14336) + 4096 x 49152
    (GQA["name"], 1_056_993_280, 855_638_016)])
def test_model_counts_by_hand(name, j, matmul):
    cfg = _config(name)
    assert weights.n_params(dense.leaf_specs(cfg)) == j
    assert yardstick.matmul_params(cfg) == matmul
    layers, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    assert yardstick.train_flops_per_token(cfg, 1024) == \
        6 * matmul + 12 * layers * d * 1024


def test_port_counts_the_same_parameters():
    for name in ("stablelm-3b-4e1t.l8", GQA["name"]):
        cfg = _config(name)
        assert dense.port_config(cfg).param_count() == weights.n_params(
            dense.leaf_specs(cfg))


def test_shares_are_percent():
    cfg = _config("stablelm-3b-4e1t.l8")
    per_s = yardstick.BF16_FLOPS_PER_S / yardstick.train_flops_per_token(
        cfg, 1024)
    assert yardstick.mfu_pct(cfg, 1024, per_s, 1) == pytest.approx(100.0)
    assert yardstick.roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
