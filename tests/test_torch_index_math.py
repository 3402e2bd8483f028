"""The index arithmetic of the redesigned kernels B3 and B4, through
the plain PyTorch versions of the steps that their CUDA code mirrors,
and the amax of B7's caller:

- the encodes' multiplicative inverse for ``% width`` (the host's 64-bit
  magic and an emulation of ``__umul64hi``) equals ``%`` on every 24-bit
  input;
- the partitioned layout of B3 and B4 (tile blocks in partition order,
  the start table) holds every (row, index) pair once, and the two-pass
  encode it feeds, of err + g (B3) or of a given a (B4), equals
  ``sketch_encode_plain`` bitwise on dyadic inputs and within
  ``sketch_error_bound`` on Gaussian ones, also at widths beyond the 2^24
  buckets a hash reaches, which have no partition;
- the threshold op's amax, taken without a J-sized |x|, equals
  ``x.abs().amax()`` bit for bit.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against the same plain versions; B7's plain version is held against the
reference in ``test_torch_topk_select.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import sketch as csk  # noqa: E402
from repro_torch.kernels.compress import kernel as pk  # noqa: E402
from repro_torch.kernels.topk_select import ops as hops  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

RAGGED = 3 * 8192 + 517
# below one partition (2^14 buckets), one bucket over it, and not a
# multiple of it
WIDTHS = (1000, (1 << 14) + 1, 100_003)


# ---------------------------------------------------------------------------
# B3: fastmod
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 512, 3_568_128, 4_000_037, 1 << 22])
def test_fastmod_equals_mod_on_every_24_bit_input(width):
    """x >> 8 of a 32-bit hash is below 2^24: the magic is exact there."""
    n = np.arange(1 << 24, dtype=np.uint64)
    got = pk.fastmod(n, pk.fastmod_magic(width), width)
    assert np.array_equal(got, n % np.uint64(width))


def test_fastmod_magic_is_the_rounded_up_inverse():
    assert pk.fastmod_magic(1) == 0               # 2^64 wraps to 0
    assert pk.fastmod_magic(2) == 1 << 63
    w = 3_568_128
    assert pk.fastmod_magic(w) == -(-(1 << 64) // w)


# ---------------------------------------------------------------------------
# B3: the partitioned layout and the two-pass encode
# ---------------------------------------------------------------------------

def _dyadic(rng, j):
    return torch.from_numpy(
        (rng.integers(-1024, 1025, j) * 2.0 ** -8).astype(np.float32))


def _gauss(rng, j, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(j)).astype(np.float32))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_start_table_covers_every_pair_once(rows, width):
    """Within each tile's block the partitions' runs follow each other:
    each run's start is the sum of the earlier runs' lengths, the runs
    hold exactly the tile's pairs of their partition, and all the tiles
    together hold rows * J pairs."""
    j = RAGGED
    plan = pk.sketch_plan(j, rows, width)
    starts = pk.sketch_starts_plain(j, rows, width)
    tiles = -(-j // pk.SKETCH_TILE)
    assert starts.shape == (plan["parts"], tiles)
    idx = torch.arange(j)
    h = torch.stack([csk.row_hash(r, width, idx)[0] for r in range(rows)])
    part = (torch.arange(rows)[:, None] * plan["per_row"]
            + (h >> pk.PART_SHIFT))
    total = 0
    for t in range(tiles):
        lo, hi = t * pk.SKETCH_TILE, min(j, (t + 1) * pk.SKETCH_TILE)
        cnt = torch.bincount(part[:, lo:hi].reshape(-1),
                             minlength=plan["parts"])
        assert int(starts[0, t]) == 0
        assert torch.equal(starts[1:, t], torch.cumsum(cnt, 0)[:-1])
        total += int(cnt.sum())
    assert total == rows * j
    assert int(starts.max()) <= rows * pk.SKETCH_TILE   # empty last runs


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_two_pass_encode_matches_plain_encode(rows, width):
    """Three chunks (the chunk cut to two tiles): the pair ids fill every
    chunk's buffer once, the sketch is bitwise on dyadic inputs (every
    partial sum exact) and within the stated bound on Gaussian ones."""
    j = 5 * pk.SKETCH_TILE + 517
    chunk_pairs = rows * 2 * pk.SKETCH_TILE
    rng = np.random.default_rng(rows * 7 + width % 11)
    g, err = _dyadic(rng, j), _dyadic(rng, j)
    a, sk, ids = pk.sweep1_sketch_parts_plain(g, err, rows, width,
                                              chunk_pairs=chunk_pairs)
    assert pk.sketch_plan(j, rows, width, chunk_pairs=chunk_pairs)[
        "nchunks"] == 3
    assert torch.equal(torch.sort(torch.cat(ids)).values,
                       torch.arange(rows * j))
    assert torch.equal(a, err + g)
    assert torch.equal(sk, pk.sketch_encode_plain(a, rows, width))
    g, err = _gauss(rng, j), _gauss(rng, j, 0.1)
    a, sk, _ = pk.sweep1_sketch_parts_plain(g, err, rows, width,
                                            chunk_pairs=chunk_pairs)
    want = pk.sketch_encode_plain(a, rows, width)
    bound = pk.sketch_error_bound(a, rows, width)
    assert bool(((sk - want).abs().double() <= bound).all())


@pytest.mark.parametrize("width", WIDTHS + (pk.HASH_BUCKETS + 1000,))
@pytest.mark.parametrize("rows", [1, 3])
def test_partitioned_sketch_encode_matches_plain_encode(rows, width):
    """B4's passes, which read a given a: three chunks at the ragged J
    (the chunk cut to two tiles), the pair ids fill every chunk's buffer
    once, the sketch is bitwise on dyadic inputs and within the stated
    bound on Gaussian ones; buckets no hash reaches stay 0."""
    j = 5 * pk.SKETCH_TILE + 517
    chunk_pairs = rows * 2 * pk.SKETCH_TILE
    rng = np.random.default_rng(rows * 5 + width % 13)
    a = _dyadic(rng, j)
    sk, ids = pk.sketch_encode_parts_plain(a, rows, width,
                                           chunk_pairs=chunk_pairs)
    assert len(ids) == 3
    assert torch.equal(torch.sort(torch.cat(ids)).values,
                       torch.arange(rows * j))
    assert torch.equal(sk, pk.sketch_encode_plain(a, rows, width))
    assert not bool(sk[:, pk.HASH_BUCKETS:].any())
    a = _gauss(rng, j)
    sk, _ = pk.sketch_encode_parts_plain(a, rows, width,
                                         chunk_pairs=chunk_pairs)
    d = (sk - pk.sketch_encode_plain(a, rows, width)).abs().double()
    assert bool((d <= pk.sketch_error_bound(a, rows, width)).all())


@pytest.mark.parametrize("rows", [1, 2])
def test_two_pass_encode_beyond_the_hash_range(rows):
    """A width past 2^24: the 1024 partitions of a row cover the buckets
    a hash reaches, so most runs are short or empty, and the later
    buckets stay 0. Still the plain encode bit for bit on dyadic
    inputs."""
    j, width = RAGGED, pk.HASH_BUCKETS + 1000
    plan = pk.sketch_plan(j, rows, width)
    assert plan["per_row"] == pk.HASH_BUCKETS >> pk.PART_SHIFT
    rng = np.random.default_rng(rows)
    g, err = _dyadic(rng, j), _dyadic(rng, j)
    a, sk, ids = pk.sweep1_sketch_parts_plain(g, err, rows, width)
    assert torch.equal(torch.sort(torch.cat(ids)).values,
                       torch.arange(rows * j))
    assert torch.equal(sk, pk.sketch_encode_plain(a, rows, width))
    assert not bool(sk[:, pk.HASH_BUCKETS:].any())


def test_sketch_plan_chunks_and_limits():
    plan = pk.sketch_plan(892_032_000, 3, 3_568_128)
    assert plan["chunk"] == 1 << 27 and plan["nchunks"] == 7
    assert plan["parts"] == 3 * 218
    assert plan["pair_bytes"] == 6 * 3 * (1 << 27)
    assert pk.sketch_plan(100, 3, 512)["pair_bytes"] == 6 * 3 * 100
    # any width the sketch accepts: at most 1024 partitions a row
    widest = pk.sketch_plan(1 << 20, csk.MAX_ROWS, (1 << 32) - 1)
    assert widest["parts"] == csk.MAX_ROWS * 1024


# ---------------------------------------------------------------------------
# the threshold op's amax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("values", [
    [-0.0, -0.0, -0.0], [0.0, 0.0], [-0.0, 0.0], [1.0, float("nan"), -3.0],
    [float("nan")], [-5.0, 2.0, -5.0], [float("-inf"), 1.0], [-1e-45, 0.0]])
def test_abs_max_equals_abs_amax_bitwise(values):
    x = torch.tensor(values, dtype=torch.float32)
    got, want = hops.abs_max(x), x.abs().amax()
    assert got.shape == want.shape == ()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_abs_max_on_gaussian_and_all_zero_inputs():
    x = _gauss(np.random.default_rng(3), RAGGED)
    for v in (x, torch.zeros(RAGGED), -torch.zeros(RAGGED)):
        assert torch.equal(hops.abs_max(v).view(torch.int32),
                           v.abs().amax().view(torch.int32))
