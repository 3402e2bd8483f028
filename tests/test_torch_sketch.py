"""Sketch-coordinated top-k in the port against the reference, bitwise:
the CountSketch hash, the plain versions of the two encode kernels (B3
``sweep1_sketch``, B4 ``sketch_encode``, and B4's step-by-step
``sketch_encode_parts_plain``) against the Pallas kernels in interpret
mode and the jitted ``sketch.encode``, the median estimate,
``GradientSync`` at a world of 1 against the reference's per-step path
under ``shard_map``, and ``round()`` against ``GradientSync.round``.

On the CPU the wrappers run their plain versions, which add each bucket's
contributions in element order as the reference does; the CUDA kernels
add with float atomics and are held against these plain versions on the
card by ``chip_smoke.py``, where each bucket's sum is exact on dyadic
inputs in any order and within ``sketch_error_bound`` on Gaussian
ones. Gaussian inputs have no subnormals (which XLA on the CPU may
flush)."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import SparsifierConfig as JaxSparsifierConfig  # noqa: E402
from repro.core import aggregate as jagg  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.kernels.compress import kernel as jk  # noqa: E402
from repro.kernels.compress import ops as jops  # noqa: E402
from repro_torch.configs.base import SparsifierConfig  # noqa: E402
from repro_torch.convert import state_from_jax, state_to_jax  # noqa: E402
from repro_torch.core import aggregate, sketch, sparsify  # noqa: E402
from repro_torch.kernels.compress import kernel as tk  # noqa: E402
from repro_torch.kernels.compress import ops as tops  # noqa: E402

J_SIZES = (4096, 3 * 4096 + 517)
WIDTH = 512
T = 3
SPARSITY = 0.01          # k = 128 at J = 12,805: auto width 4k = 512
HASH = dict(mults=tuple(int(x) for x in jsk._MULTS),
            adds=tuple(int(x) for x in jsk._ADDS))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _same(want, got):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    return np.array_equal(_bits(want), _bits(got))


def _gauss(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _dyadic(rng, *shape):
    """k * 2^-8 with |k| <= 2^10: every partial sum of a few thousand of
    them is exact in fp32, in any order."""
    return (rng.integers(-1024, 1025, shape) * 2.0 ** -8).astype(np.float32)


@pytest.mark.parametrize("j", J_SIZES)
@pytest.mark.parametrize("rows", [2, 3, 4])
def test_plain_sweep1_sketch_matches_pallas(j, rows):
    rng = np.random.default_rng(j + rows)
    g, err = _gauss(rng, j), _gauss(rng, j, scale=0.1)
    enc = jax.jit(lambda g_, e_: jops.fused_sketch_encode(
        g_, e_, rows=rows, width=WIDTH, strategy="pallas_interpret"))(g, err)
    got = tops.fused_sketch_encode(torch.from_numpy(g), torch.from_numpy(err),
                                   rows=rows, width=WIDTH)
    assert _same(enc["a"], got["a"])
    assert _same(enc["sketch"], got["sketch"])


@pytest.mark.parametrize("j", J_SIZES)
def test_plain_sketch_encode_matches_pallas_and_encode(j):
    rng = np.random.default_rng(10 + j)
    a = _gauss(rng, j)
    rows = 3
    want = jk.sketch_encode_pallas(jnp.asarray(a), rows=rows, width=WIDTH,
                                   interpret=True, mults=HASH["mults"][:rows],
                                   adds=HASH["adds"][:rows])
    want_enc = jax.jit(lambda x: jsk.encode(x, rows, WIDTH))(a)
    got = sketch.encode(torch.from_numpy(a), rows, WIDTH)
    assert _same(want, got) and _same(want_enc, got)


# below one partition of the card's encode (2^14 buckets), one bucket over
# it and not a multiple of it, and beyond the 2^24 buckets a hash reaches
PART_WIDTHS = (1000, (1 << 14) + 1, 100_003, (1 << 24) + 1000)


@pytest.mark.parametrize("width", PART_WIDTHS)
@pytest.mark.parametrize("rows", [1, 3])
def test_partitioned_sketch_encode_matches_pallas(rows, width):
    """B4's step-by-step plain version (the card kernel's two passes, two
    chunks of one tile) at the ragged J on dyadic a: the Pallas kernel in
    interpret mode, the plain encode and the wrapper, bitwise."""
    j = J_SIZES[1]
    a = _dyadic(np.random.default_rng(rows + width % 17), j)
    want = jk.sketch_encode_pallas(jnp.asarray(a), rows=rows, width=width,
                                   interpret=True, mults=HASH["mults"][:rows],
                                   adds=HASH["adds"][:rows])
    x = torch.from_numpy(a)
    got, _ = tk.sketch_encode_parts_plain(
        x, rows, width, chunk_pairs=rows * tk.SKETCH_TILE)
    assert _same(want, got)
    assert _same(want, tk.sketch_encode_plain(x, rows, width))
    assert _same(want, sketch.encode(x, rows, width, {}))


def test_hashes_match_reference():
    j, rows = J_SIZES[1], 8
    h, s = jax.jit(lambda: jsk._hashes(j, rows, WIDTH))()
    th, ts = sketch.hashes(j, rows, WIDTH)
    assert _same(np.asarray(h).astype(np.int64), th)
    assert _same(s, ts)


@pytest.mark.parametrize("rows", [2, 3, 4])
def test_estimate_matches_reference(rows):
    """Even row counts average the two middle values, as jnp.median
    does; a column holding a NaN estimates NaN."""
    j = J_SIZES[1]
    rng = np.random.default_rng(rows)
    sk = _gauss(rng, rows, WIDTH)
    sk[rows - 1, 7] = np.nan
    want = jax.jit(lambda x: jsk.estimate(x, j))(sk)
    got = sketch.estimate(torch.from_numpy(sk), j)
    assert np.isnan(np.asarray(want)).any()
    assert _same(want, got)


def test_resolve_width_cap_explicit_and_warn_once():
    assert sketch.resolve_width(10) == 256
    assert sketch.resolve_width(1000) == 4000
    assert sketch.resolve_width(1000, 777) == 777
    k = (1 << 22) // 4 + 12345
    sketch._CAP_WARNED.discard(k)
    with pytest.warns(RuntimeWarning, match="auto-width cap"):
        assert sketch.resolve_width(k) == 1 << 22
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sketch.resolve_width(k) == 1 << 22
    for k in (10, 1000, (1 << 22) // 4, k + 1):
        jsk._CAP_WARNED.add(k)
        sketch._CAP_WARNED.add(k)
        assert sketch.resolve_width(k) == jsk.resolve_width(k)


def test_shape_limits_raise():
    with pytest.raises(ValueError, match="rows"):
        sketch.check_shape(100, 9, WIDTH)
    with pytest.raises(ValueError, match="uint32"):
        sketch.check_shape(1 << 32, 3, WIDTH)
    sketch.check_shape((1 << 32) - 1, 3, WIDTH)


def test_plain_versions_bound_memory_by_chunks(monkeypatch):
    """The plain encodes and the estimate work chunk by chunk over J (so
    they run at full J on the card); chunking must not change a bit."""
    j, rows = 5 * tk.BLOCK + 77, 3
    rng = np.random.default_rng(4)
    g = torch.from_numpy(_gauss(rng, j))
    err = torch.from_numpy(_gauss(rng, j, scale=0.1))
    a, sk = tk.sweep1_sketch_plain(g, err, rows, WIDTH)
    gmag = sketch.estimate(sk, j)
    bound = tk.sketch_error_bound(a, rows, WIDTH)
    monkeypatch.setattr(tk, "_PLAIN_ROWS", 2)
    monkeypatch.setattr(sketch, "_ESTIMATE_CHUNK", 3000)
    a2, sk2 = tk.sweep1_sketch_plain(g, err, rows, WIDTH)
    assert torch.equal(a, a2) and torch.equal(sk, sk2)
    assert torch.equal(gmag, sketch.estimate(sk, j))
    assert torch.equal(bound, tk.sketch_error_bound(a, rows, WIDTH))


def test_error_bound_covers_another_summation_order():
    """The card's atomics add in another order; the stated per-bucket
    bound covers the sum taken in reverse element order."""
    j, rows = J_SIZES[1], 3
    a = torch.from_numpy(_gauss(np.random.default_rng(5), j))
    fwd = tk.sketch_encode_plain(a, rows, WIDTH)
    h, s = sketch.hashes(j, rows, WIDTH)
    rev = torch.zeros(rows, WIDTH)
    for r in range(rows):
        rev[r].index_add_(0, h[r].flip(0), (s[r] * a).flip(0))
    bound = tk.sketch_error_bound(a, rows, WIDTH)
    assert not torch.equal(fwd, rev)          # the orders do differ
    assert bool(((fwd - rev).abs().double() <= bound).all())


def _cfgs(pipeline):
    kw = dict(kind="sketchtopk", sparsity=SPARSITY, comm_mode="sparse",
              pipeline=pipeline)
    return JaxSparsifierConfig(**kw), SparsifierConfig(**kw)


def _jax_sync(cfg, st):
    mesh = jax.make_mesh((1,), ("data",))

    def f(g_, st_):
        return jagg.GradientSync(cfg, ("data",))(st_, g_)

    spec = jax.tree_util.tree_map(lambda _: P(), st)
    with mesh:
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("data"), spec),
                                     out_specs=(P("data"), spec),
                                     check_vma=False))


@pytest.mark.parametrize("pipeline", ["fused", "reference"])
def test_world1_sync_matches_reference(pipeline):
    """The port's GradientSync call at a world of 1 against the
    reference's per-step path (sketch psum, decode, values-only combine,
    O(k) error feedback) on a 1-device mesh, T steps, bitwise. The port
    starts from the reference's state, converted."""
    j = J_SIZES[1]
    jcfg, tcfg = _cfgs(pipeline)
    jst = jsp.init_state(jcfg, j)
    tst = state_from_jax(jax.device_get(jst))
    assert set(tst) == {sparsify.err_key(tcfg), "step"}
    fn = _jax_sync(jcfg, jst)
    sync = aggregate.GradientSync(tcfg)
    rng = np.random.default_rng(20)
    for t in range(T):
        g = _gauss(rng, j)
        with jax.make_mesh((1,), ("data",)):
            jg, jst = fn(jnp.asarray(g), jst)
        tg, tst = sync(tst, torch.from_numpy(g))
        assert _same(jg, tg), t
        assert int((tg != 0).sum()) == sparsify.resolve_k(tcfg, j)
        for key, val in state_to_jax(tst).items():
            assert _same(np.asarray(jst[key]), val), (t, key)


def _jax_round(cfg, states, grads):
    return jax.jit(lambda s, g: jagg.GradientSync(cfg, None).round(s, g))(
        states, [jnp.asarray(x) for x in grads])


@pytest.mark.parametrize("n,data", [(2, "gauss"), (4, "dyadic")])
@pytest.mark.parametrize("pipeline", ["fused", "reference"])
def test_round_matches_reference(n, data, pipeline):
    j = J_SIZES[1]
    jcfg, tcfg = _cfgs(pipeline)
    rng = np.random.default_rng(n)
    jstates = [jsp.init_state(jcfg, j) for _ in range(n)]
    tstates = [sparsify.init_state(tcfg, j, "cpu") for _ in range(n)]
    sync = aggregate.GradientSync(tcfg)
    for t in range(T):
        grads = [_gauss(rng, j) if data == "gauss" else _dyadic(rng, j)
                 for _ in range(n)]
        jg, jstates = _jax_round(jcfg, jstates, grads)
        tg, tstates = sync.round(tstates, [torch.from_numpy(x)
                                           for x in grads])
        assert _same(jg, tg), t
        for js, ts in zip(jstates, tstates):
            for key, val in state_to_jax(ts).items():
                assert _same(np.asarray(js[key]), val), (t, key)


def test_compress_raises_for_sketch():
    _, tcfg = _cfgs("fused")
    st = sparsify.init_state(tcfg, 100, "cpu")
    with pytest.raises(RuntimeError, match="aggregate-level"):
        sparsify.compress(tcfg, st, torch.zeros(100))
    ref = dataclasses.replace(tcfg, pipeline="reference")
    assert set(sparsify.init_state(ref, 100, "cpu")) == {"err", "step"}
