"""The port's sweep kernels, plain versions on the CPU, against the
reference's Pallas kernels run in interpret mode (bitwise), sweep 1 in
both its plain and its dgc mode.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``. Inputs are drawn from normal distributions, so no
subnormals occur (XLA on the CPU may flush them)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.compress import kernel as jk  # noqa: E402
from repro.kernels.compress import ops as jops  # noqa: E402
from repro_torch.kernels.compress import kernel as tk  # noqa: E402
from repro_torch.kernels.compress.ops import maxpb_for  # noqa: E402


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _same(jax_out, torch_out):
    return np.array_equal(_bits(jax_out), _bits(torch_out.numpy()))


def _inputs(j, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(j).astype(np.float32)
    err = (0.1 * rng.standard_normal(j)).astype(np.float32)
    return g, err


@pytest.mark.parametrize("c", [1.0, 0.8807971])
def test_sweep1_matches_pallas(c):
    g, err = _inputs(3 * jk.BLOCK, 0)
    c = np.float32(c)
    a, score, _, amax, hist = jk.sweep1_pallas(
        jnp.asarray(g), jnp.asarray(err), c, interpret=True)
    ta, tscore, tamax, thist = tk.sweep1(
        torch.from_numpy(g), torch.from_numpy(err), torch.tensor([c]))
    assert _same(a, ta) and _same(score, tscore)
    assert _same(amax, tamax) and _same(hist, thist)


@pytest.mark.parametrize("target", [30, 200])
def test_sweep2_matches_pallas(target):
    g, err = _inputs(3 * jk.BLOCK, 1)
    score = torch.from_numpy(err + g)
    _, _, _, hist = tk.sweep1(torch.from_numpy(g), torch.from_numpy(err),
                              torch.ones(1))
    tau = tk.threshold_from_hist(hist, target)
    maxpb = 64
    _, vals, idx, cnt = jk.sweep2_pallas(
        jnp.asarray(score.numpy()), np.asarray(tau)[0], maxpb=maxpb,
        interpret=True, want_mask=False)
    tvals, tidx, tcnt = tk.sweep2(score, tau, maxpb)
    assert _same(vals, tvals) and _same(idx, tidx) and _same(cnt, tcnt)


def test_sweeps_ragged_match_callers():
    """At a ragged J the port masks the tail itself; compare with the
    reference caller, which pads, corrects bin 0 and kills pad slots."""
    j = 2 * jk.BLOCK + 1000
    g, err = _inputs(j, 2)
    c = np.float32(0.9)
    a, score_p, _, hist = jops._sweep1_slice(
        "regtopk", jnp.asarray(g), jnp.asarray(err), c, momentum=0.0,
        mom_s=None, interpret=True)
    ta, tscore, _, thist = tk.sweep1(torch.from_numpy(g),
                                     torch.from_numpy(err),
                                     torch.tensor([c]))
    assert _same(a, ta) and _same(np.asarray(score_p)[:j], tscore)
    assert _same(hist, thist)
    k = 40
    tau = tk.threshold_from_hist(thist, 2 * k)
    assert float(tau) > 0
    maxpb = maxpb_for(k, j)
    ck, ci, ok = jops._sweep2_slice(score_p, np.asarray(tau)[0], 0, j,
                                    maxpb, True)
    tvals, tidx, tcnt = tk.sweep2(tscore, tau, maxpb)
    assert _same(ck, tvals) and _same(ci, tidx)
    assert bool(ok) == bool(tcnt.max() <= maxpb)


def test_threshold_and_key_edge_match():
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 50, size=jk.BINS).astype(np.int32)
    for target in (1, 17, 500, int(hist.sum()), int(hist.sum()) + 1):
        want = jk.threshold_from_hist(jnp.asarray(hist), target)
        got = tk.threshold_from_hist(torch.from_numpy(hist), target)
        assert _same(np.asarray(want).reshape(1), got)
    x = np.abs(rng.standard_normal(1000).astype(np.float32)) * 100
    assert _same(jk.key_bin_edge(jnp.asarray(x)),
                 tk.key_bin_edge(torch.from_numpy(x)))
    assert _same(jk.bit_bin(jnp.asarray(x)), tk.bit_bin(torch.from_numpy(x)))


def test_plain_versions_bound_memory_by_chunks(monkeypatch):
    """The plain versions process tiles in chunks (so they run at full J
    on the card); chunking must not change any output."""
    g, err = _inputs(5 * jk.BLOCK + 77, 4)
    g, err = torch.from_numpy(g), torch.from_numpy(err)
    c = torch.tensor([0.75])
    whole1 = tk.sweep1_plain(g, err, c)
    tau = tk.threshold_from_hist(whole1[3], 60)
    whole2 = tk.sweep2_plain(whole1[1], tau, 40)
    monkeypatch.setattr(tk, "_PLAIN_ROWS", 2)
    for a, b in zip(whole1 + whole2,
                    tk.sweep1_plain(g, err, c)
                    + tk.sweep2_plain(whole1[1], tau, 40)):
        assert torch.equal(a, b)


def test_sweep1_dgc_matches_pallas():
    """dgc mode (c = 1, momentum 0.9): a, score, mom', amax and hist
    bitwise. |mom| ~ |g|, so an unfused multiply-add would differ from
    the compiled kernel's fused one in thousands of elements."""
    g, err = _inputs(3 * jk.BLOCK, 5)
    mom = np.random.default_rng(6).standard_normal(g.size).astype(np.float32)
    a, score, mom_out, amax, hist = jk.sweep1_pallas(
        jnp.asarray(g), jnp.asarray(err), np.float32(1.0), mode="dgc",
        momentum=0.9, mom=jnp.asarray(mom), interpret=True)
    before = tk.sweep1_dgc.launches
    ta, tscore, tamax, thist, tmom = tk.sweep1(
        torch.from_numpy(g), torch.from_numpy(err), torch.ones(1),
        torch.from_numpy(mom), 0.9)
    assert tk.sweep1_dgc.launches == before      # the CPU runs no kernel
    assert _same(a, ta) and _same(score, tscore) and _same(mom_out, tmom)
    assert _same(amax, tamax) and _same(hist, thist)


def test_sweep1_dgc_ragged_matches_caller():
    """dgc mode at a ragged J against the reference's caller
    ``ops._sweep1_slice``, which pads and corrects bin 0."""
    j = 2 * jk.BLOCK + 1000
    g, err = _inputs(j, 7)
    mom = np.random.default_rng(8).standard_normal(j).astype(np.float32)
    a, score_p, mom_out, hist = jops._sweep1_slice(
        "dgc", jnp.asarray(g), jnp.asarray(err), np.float32(1.0),
        momentum=0.9, mom_s=jnp.asarray(mom), interpret=True)
    ta, tscore, _, thist, tmom = tk.sweep1_dgc(
        torch.from_numpy(g), torch.from_numpy(err), torch.from_numpy(mom),
        torch.ones(1), 0.9)
    assert _same(a, ta) and _same(np.asarray(score_p)[:j], tscore)
    assert _same(mom_out, tmom) and _same(hist, thist)


def test_fma_f32_rounds_once(monkeypatch):
    """numerics.fma_f32 is a fused multiply-add: one rounding, also where
    the fp64 sum lands exactly on an fp32 midpoint (a naive fp64 sum
    would round twice there), and chunking does not change it."""
    from repro_torch.core import numerics
    # p = (1 + 2^-18) * (1 - 2^-18) * 2^-24 = 2^-24 - 2^-60; c = 1 + 2^-23:
    # p + c lies 2^-60 below the midpoint 1 + 3 * 2^-24, so it rounds
    # down to c, where a double rounding reaches the midpoint and then
    # rounds to even, 1 + 2^-22
    a = torch.tensor([(1 - 2.0 ** -18) * 2.0 ** -24], dtype=torch.float32)
    b = torch.tensor(1 + 2.0 ** -18, dtype=torch.float32)
    c = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    naive = (a.double() * b.double() + c.double()).float()
    assert naive.item() == 1 + 2.0 ** -22
    assert numerics.fma_f32(a, b, c).item() == 1 + 2.0 ** -23
    assert numerics.fma_f32(-a, b, -c).item() == -(1 + 2.0 ** -23)
    rng = np.random.default_rng(9)
    x, y = (torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
            for _ in range(2))
    whole = numerics.fma_f32(x, 0.9, y)
    want = jax.jit(lambda m, g: 0.9 * m + g)(x.numpy(), y.numpy())
    assert _same(want, whole)
    monkeypatch.setattr(numerics, "_FMA_CHUNK", 777)
    assert torch.equal(numerics.fma_f32(x, 0.9, y), whole)
