"""The port's threshold top-k selection against the reference, bitwise:
the plain version of the histogram kernel (B7) against the Pallas kernel
in interpret mode, ``histogram_threshold_op`` (tau) and ``topk_mask_op``
against the reference's ops under ``jax.jit``, and ``select.topk_mask``
for the exact, histogram and histogram_kernel selectors.

Cases: Gaussian inputs, a ragged J (the port pads nothing; the reference
pads and corrects bin 0), an all-zero input (amax = 0: the kernel's op
floors amax at 1e-30, the plain selector takes 1.0), entries exactly on
bin edges, and NaN. On the CPU the wrapper runs its plain version; the
CUDA kernel is held against it on the card by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import select as jsel  # noqa: E402
from repro.kernels.topk_select import ops as jops  # noqa: E402
from repro.kernels.topk_select.kernel import histogram_pallas  # noqa: E402
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
