"""The dense reference-layout REGTOP-k kernels of the port (B5 ``scores``,
B6 ``apply``), plain versions on the CPU, against the reference's Pallas
kernels run in interpret mode under ``jax.jit`` (bitwise).

The grid covers mu, Q and omega as the compiled reference folds them
(``/ mu`` becomes ``* f32(1/mu)``), s_prev 0/1, exact zeros of a and
tiny negative a whose safe denominator is 0 (a division by zero). On the
CPU each wrapper runs its plain version; the CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``. Inputs
are drawn from normal distributions, so no subnormals occur (XLA on the
CPU may flush them)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_ef import ops as jops  # noqa: E402
from repro_torch.kernels.fused_ef import kernel as tk  # noqa: E402
from repro_torch.kernels.fused_ef import ops as tops  # noqa: E402

J = 3 * 4096 + 517       # ragged: the port pads nothing


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _same(want, got):
    return np.array_equal(_bits(want), _bits(got.numpy()))


def _inputs(seed, j=J):
    """g, err, a_prev, g_agg, s_prev with exact zeros of a = err + g
    (err = -g) and tiny negative a (|omega * a| <= 1e-12)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(j).astype(np.float32)
    err = (0.1 * rng.standard_normal(j)).astype(np.float32)
    zero = rng.choice(j, 64, replace=False)
    err[zero] = -g[zero]
    tiny = rng.choice(np.setdiff1d(np.arange(j), zero), 16, replace=False)
    g[tiny], err[tiny] = np.float32(-1e-13), 0.0
    a_prev = rng.standard_normal(j).astype(np.float32)
    g_agg = (0.5 * rng.standard_normal(j)).astype(np.float32)
    s_prev = (rng.random(j) < 0.3).astype(np.float32)
    return g, err, a_prev, g_agg, s_prev


@pytest.mark.parametrize("mu", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("Q", [0.0, 0.3])
@pytest.mark.parametrize("omega", [1.0, 0.25, 0.125, 1 / 3, 0.1])
def test_scores_match_pallas(mu, Q, omega):
    """omega = 1/3 and 0.1 (worlds of 3 and 10) make omega * a_prev
    inexact: the compiled reference rounds g_agg - omega * a_prev once."""
    ins = _inputs(int(mu * 10) + int(Q * 10) * 7 + round(1 / omega))
    want_a, want_s = jax.jit(lambda *xs: jops.fused_regtopk_scores(
        *xs, omega=omega, mu=mu, Q=Q))(*(jnp.asarray(x) for x in ins))
    got_a, got_s = tops.fused_regtopk_scores(
        *(torch.from_numpy(x) for x in ins), omega=omega, mu=mu, Q=Q)
    assert _same(want_a, got_a)
    assert (np.asarray(want_a) == 0).sum() >= 64
    assert not np.isfinite(np.asarray(want_s)).all()   # the zero divisors
    assert _same(want_s, got_s)


def test_apply_matches_pallas():
    g, err, _, _, s = _inputs(3)
    a = g + err
    want_gh, want_err = jax.jit(jops.fused_apply_mask)(jnp.asarray(a),
                                                       jnp.asarray(s))
    got_gh, got_err = tops.fused_apply_mask(torch.from_numpy(a),
                                            torch.from_numpy(s))
    assert _same(want_gh, got_gh) and _same(want_err, got_err)
    # mask * a keeps the sign of a at unselected entries (-0.0)
    assert np.signbit(np.asarray(want_gh)[(s == 0) & (a < 0)]).all()


def test_plain_versions_bound_memory_by_chunks(monkeypatch):
    """The plain versions work chunk by chunk (so they run at full J on
    the card); chunking must not change a bit."""
    ins = [torch.from_numpy(x) for x in _inputs(5)]
    kw = dict(omega=0.5, mu=0.3, Q=0.3)
    a, s = tk.scores_plain(*ins, **kw)
    gh, e = tk.apply_plain(a, ins[4])
    monkeypatch.setattr(tk, "_PLAIN_CHUNK", 1000)
    a2, s2 = tk.scores_plain(*ins, **kw)
    gh2, e2 = tk.apply_plain(a2, ins[4])
    for x, y in ((a, a2), (s, s2), (gh, gh2), (e, e2)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_wrappers_check_their_inputs():
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="s_prev"):
        tk.scores(x, x, x, x, torch.zeros(63), omega=1.0, mu=0.5, Q=0.0)
    with pytest.raises(ValueError, match="mask"):
        tk.apply(x, torch.zeros(64, dtype=torch.float64))
    before = (tk.scores.launches, tk.apply.launches)
    tk.scores(x, x, x, x, x, omega=1.0, mu=0.5, Q=0.0)
    tk.apply(x, x)
    assert (tk.scores.launches, tk.apply.launches) == before   # CPU: plain
