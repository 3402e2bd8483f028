"""The port's threshold top-k selection against the reference, bitwise:
the plain version of the histogram kernel (B7) against the Pallas kernel
in interpret mode, ``histogram_threshold_op`` (tau) and ``topk_mask_op``
against the reference's ops under ``jax.jit``, and ``select.topk_mask``
for the exact, histogram and histogram_kernel selectors.

Cases: Gaussian inputs, a ragged J (the port pads nothing; the reference
pads and corrects bin 0), an all-zero input (amax = 0: the kernel's op
floors amax at 1e-30, the plain selector takes 1.0), entries exactly on
bin edges, and NaN; for fixed amax values (the 1e-30 floor and a NaN amax
among them) every bin edge and its fp32 neighbours, and whole inputs with
NaN and inf entries. On the CPU the wrapper runs its plain version; the
CUDA kernel is held against it on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import select as jsel  # noqa: E402
from repro.kernels.topk_select import ops as jops  # noqa: E402
from repro.kernels.topk_select.kernel import histogram_pallas  # noqa: E402
from repro.kernels.topk_select.ref import histogram_ref  # noqa: E402
from repro_torch.core import select as tsel  # noqa: E402
from repro_torch.kernels.topk_select import kernel as tk  # noqa: E402
from repro_torch.kernels.topk_select import ops as tops  # noqa: E402

RAGGED = 3 * 4096 + 517
K = (1, 37, 400)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _same(want, got):
    return np.array_equal(_bits(want), _bits(got.numpy()))


def _data(kind, j, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        return rng.standard_normal(j).astype(np.float32)
    if kind == "zeros":
        return np.zeros(j, np.float32)
    if kind == "edges":
        # |x| = b / 2048 * amax exactly (amax = 4.0): every entry sits on
        # a bin's lower edge, many tie
        x = (rng.integers(0, 2049, j) / 2048.0 * 4.0).astype(np.float32)
        x[7] = 4.0
        return np.where(rng.random(j) < 0.5, -x, x).astype(np.float32)
    x = rng.standard_normal(j).astype(np.float32)      # "nan"
    x[rng.choice(j, 5, replace=False)] = np.nan
    return x


@pytest.mark.parametrize("kind", ["gauss", "zeros", "edges", "nan"])
def test_plain_histogram_matches_pallas(kind):
    x = _data(kind, 3 * 4096)
    amax = jnp.max(jnp.abs(jnp.asarray(x)))
    want = histogram_pallas(jnp.asarray(x), amax, interpret=True)
    got = tk.histogram(torch.from_numpy(x), torch.tensor(np.asarray(amax)))
    assert _same(want, got)
    assert int(got.sum()) == x.size


def test_nan_entries_count_in_bin_zero():
    """A NaN x lands in bin 0 in the plain version and the Pallas kernel
    (XLA converts NaN to 0); a NaN amax (jnp.max propagates it) puts
    every entry in bin 0 in both."""
    x = _data("nan", 4096)
    good = np.float32(np.nanmax(np.abs(x)))
    got = tk.histogram(torch.from_numpy(x), torch.tensor(good))
    finite = tk.histogram(torch.from_numpy(np.nan_to_num(x, nan=0.0)),
                          torch.tensor(good))
    assert torch.equal(got, finite)
    all0 = tk.histogram(torch.from_numpy(x), torch.tensor(np.nan))
    want = histogram_pallas(jnp.asarray(x), jnp.float32(np.nan),
                            interpret=True)
    assert _same(want, all0) and int(all0[0]) == x.size


# the 1e-30 floor, two amax below it (0.0 and 2^-126, both floored) and
# a large amax among them
AMAXES = (1.0, 4.0, 3.7e-3, float(np.float32(1e-30)), 0.0, float("nan"),
          2.0 ** -126, 1e30)


def _bin_edges(amax):
    """t_b, b = 1..2047: the least fp32 y >= 0 with RN(y / amax) * 2048
    >= b, by bisection over the bit patterns (finite amax > 0)."""
    a = np.float32(amax)
    b = np.arange(1, tk.BINS, dtype=np.float32)
    lo = np.zeros(b.size, np.int64)
    hi = np.full(b.size, a.view(np.int32), np.int64)
    while (lo < hi).any():
        mid = (lo + hi) // 2
        ok = mid.astype(np.int32).view(np.float32) / a * np.float32(tk.BINS) >= b
        hi, lo = np.where(ok, mid, hi), np.where(ok, lo, mid + 1)
    return hi.astype(np.int32).view(np.float32)


def _reference_histogram(x, amax):
    return jax.jit(histogram_ref)(jnp.asarray(x), jnp.float32(amax))


@pytest.mark.parametrize("amax", AMAXES)
def test_histogram_at_every_bin_edge_matches_reference(amax):
    """Every interior edge of amax' = max(amax, 1e-30), its two fp32
    neighbours, their negatives and amax' itself: the values where a bin
    is easiest to get wrong."""
    floor = np.float32(max(amax, tk.AMAX_FLOOR) if amax == amax else 4.0)
    t = _bin_edges(floor)
    if amax == amax:
        assert (t[1:] > t[:-1]).all()
        assert (t / floor * np.float32(tk.BINS) >= np.arange(1, tk.BINS)).all()
    x = np.concatenate([t, np.nextafter(t, np.float32(0)),
                        np.nextafter(t, np.float32(np.inf)), [floor]])
    x = np.concatenate([x, -x]).astype(np.float32)
    got = tk.histogram(torch.from_numpy(x), torch.tensor(np.float32(amax)))
    assert _same(_reference_histogram(x, amax), got)
    assert int(got.sum()) == x.size


@pytest.mark.parametrize("kind", ["gauss", "edges", "nan", "inf"])
@pytest.mark.parametrize("amax", AMAXES)
def test_histogram_for_a_given_amax_matches_reference(kind, amax):
    """Whole inputs against an amax the caller gives: 0.0 is floored to
    f32(1e-30), a NaN amax puts every entry in bin 0."""
    rng = np.random.default_rng(1)
    floor = max(amax, tk.AMAX_FLOOR) if amax == amax else 1.0
    if kind == "edges":        # |x| = b / 2048 * amax' exactly
        x = rng.integers(0, 2049, RAGGED) / 2048.0 * floor
    else:
        x = rng.standard_normal(RAGGED) * floor
    x = x.astype(np.float32)
    if kind == "nan":
        x[::997] = np.nan
    if kind == "inf":
        x[::991] = np.inf
    got = tk.histogram(torch.from_numpy(x), torch.tensor(np.float32(amax)))
    assert _same(_reference_histogram(x, amax), got)
    assert int(got.sum()) == x.size


@pytest.mark.parametrize("kind", ["gauss", "zeros", "edges", "nan"])
@pytest.mark.parametrize("k", K)
def test_threshold_op_and_mask_match_reference(kind, k):
    x = _data(kind, RAGGED, seed=k)
    tau = jax.jit(lambda v: jops.histogram_threshold_op(v, k))(x)
    mask = jax.jit(lambda v: jops.topk_mask_op(v, k))(x)
    tx = torch.from_numpy(x)
    assert _same(tau, tops.histogram_threshold_op(tx, k))
    got = tops.topk_mask_op(tx, k)
    assert _same(mask, got)
    if kind != "nan":
        assert int(got.sum()) >= k


@pytest.mark.parametrize("method", ["exact", "histogram",
                                    "histogram_kernel"])
@pytest.mark.parametrize("kind", ["gauss", "zeros", "edges"])
def test_topk_mask_matches_reference(method, kind):
    x = _data(kind, RAGGED, seed=3)
    for k in K:
        want = jax.jit(lambda v: jsel.topk_mask(v, k, method))(x)
        assert _same(want, tsel.topk_mask(torch.from_numpy(x), k, method)), k


@pytest.mark.parametrize("k", K)
def test_histogram_threshold_matches_reference(k):
    for kind in ("gauss", "zeros", "edges"):
        x = _data(kind, RAGGED, seed=k)
        want = jax.jit(lambda v: jsel.histogram_threshold(v, k))(x)
        assert _same(want, tsel.histogram_threshold(torch.from_numpy(x),
                                                    k)), kind


def test_linear_histogram_chunks(monkeypatch):
    x = torch.from_numpy(_data("gauss", RAGGED))
    amax = x.abs().amax()
    whole = tsel.linear_histogram(x, amax)
    monkeypatch.setattr(tsel, "_HIST_CHUNK", 1000)
    assert torch.equal(whole, tsel.linear_histogram(x, amax))


def test_histogram_checks_its_inputs():
    with pytest.raises(ValueError, match="amax"):
        tk.histogram(torch.zeros(64), torch.zeros(2))
    with pytest.raises(ValueError, match="x"):
        tk.histogram(torch.zeros(64, dtype=torch.float64), torch.zeros(()))
