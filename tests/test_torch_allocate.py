"""Density allocation on the port against the reference, bitwise.

The apportionment functions (``segment_bounds``, ``layer_segments`` with
empty leaves, ``segment_caps``, ``proportional_counts``) are Python ints
and must agree exactly. The adaptive split is fp32 arithmetic that XLA
compiles: its counts and the moments it reads are held against
``jax.jit`` of the reference's functions, on random moments and on
moments built to put the cumulative quotas one or two ulps from a .5
rounding boundary, with segment counts past 32 (where XLA's sum goes by
windows of 32). Then one compress step after another on both pipelines,
for every kind of ``ALLOCATED_KINDS`` in both modes, against the
reference's jitted compress + observe_aggregate (values, indices, count
and every state tensor bitwise), elastic participation included, the
reference's adaptive REGTOP-k stress inputs (which take the port's
dense fallback), and one case against the reference's Pallas strategy
in interpret mode. Tolerance: none (bit patterns) throughout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SparsifierConfig as JaxSparsifierConfig  # noqa: E402
from repro.core import allocate as jal  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.kernels.compress import ops as jops  # noqa: E402
from repro_torch.configs.base import SparsifierConfig  # noqa: E402
from repro_torch.convert import state_to_jax  # noqa: E402
from repro_torch.core import allocate as tal  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.kernels.compress import ops as tops  # noqa: E402

T = 3
J = 3 * 4096 + 1000          # ragged: no segment is a whole number of tiles
MU = 0.5
MASK = (True, False, True)
BASE = dict(comm_mode="sparse", sparsity=0.01, mu=MU, num_segments=5)


def _bits(x):
    """Bit patterns of a numpy array or a tensor (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _eq(want, got) -> bool:
    return np.array_equal(_bits(want), _bits(got))


# ---------------------------------------------------------------------------
# the apportionment functions (Python ints)
# ---------------------------------------------------------------------------

def test_apportionment_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        s = int(rng.integers(1, 40))
        sizes = [int(x) for x in rng.integers(1, 5000, s)]
        j = sum(sizes)
        for k in (1, s - 1, s, int(rng.integers(1, j + 1)), j, j + 7):
            k = max(1, k)
            assert tal.proportional_counts(k, sizes) == \
                jal.proportional_counts(k, sizes), (k, sizes)
            assert tal.segment_caps(k, sizes) == \
                jal.segment_caps(k, sizes), (k, sizes)
        ns = int(rng.integers(0, 50))
        assert tal.segment_bounds(j, ns or 1) == \
            jal.segment_bounds(j, ns or 1)
        for nb in (1, 3):
            cfg = dict(num_segments=ns, num_buckets=nb)
            assert tal.resolve_num_segments(SparsifierConfig(**cfg), j) == \
                jal.resolve_num_segments(JaxSparsifierConfig(**cfg), j)


def test_layer_segments_match_reference():
    """Leaf sizes with empty leaves anywhere (first, last, in runs), as
    sizes and as (offset, size) pairs; and more segments than leaves."""
    rng = np.random.default_rng(1)
    cases = [[0, 5, 0, 0, 7, 0], [0], [0, 0], [3], [4000, 100, 2900, 3000],
             [1, 1, 1, 1, 1]]
    for _ in range(200):
        n = int(rng.integers(1, 30))
        sizes = [int(x) for x in rng.integers(0, 300, n)]
        sizes = [0 if rng.random() < 0.2 else x for x in sizes]
        cases.append(sizes)
    for sizes in cases:
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
        pairs = list(zip(offs, sizes))
        for ms in (1, 2, 3, 8, 64):
            want = jal.layer_segments(sizes, ms)
            assert tal.layer_segments(sizes, ms) == want, (sizes, ms)
            assert tal.layer_segments(pairs, ms) == \
                jal.layer_segments(pairs, ms) == want


# ---------------------------------------------------------------------------
# adaptive counts and moments (fp32, as compiled)
# ---------------------------------------------------------------------------

def _jit_counts(k, sizes, caps):
    return jax.jit(lambda m: jal.adaptive_counts(k, sizes, m, caps=caps))


def _near_half_moments(rng, sizes, k):
    """Moments m_l = c * J_l (every ratio 1, quota k * J_l / J) with a
    few of them nudged by one or two ulps: the quotas then sit a hair
    from the .5 boundaries the cumulative rounding resolves."""
    m = np.asarray(sizes, np.float32) * np.float32(rng.uniform(0.5, 4.0))
    for i in rng.choice(len(sizes), max(1, len(sizes) // 3), replace=False):
        for _ in range(int(rng.integers(1, 3))):
            m[i] = np.nextafter(m[i], np.float32(np.inf if rng.random() < 0.5
                                                 else 0.0))
    return m


@pytest.mark.parametrize("s", [1, 5, 8, 20, 40])
def test_adaptive_counts_bitwise_with_compiled_reference(s):
    """Random moments (zero, tiny, huge, clipped either way) and
    near-.5 quotas: equal sizes with k = S * n + S // 2, so k * J_l / J
    lands on x.5, and the moments nudged by an ulp or two. S past 16
    and 32 (XLA's scan rows and sum windows)."""
    rng = np.random.default_rng(s)
    checked = 0
    for trial in range(8):
        if trial % 2:
            half = int(rng.integers(50, 3000))
            sizes = [half] * s
            k = int(s * rng.integers(1, 40) + s // 2 or 1)
            m = _near_half_moments(rng, sizes, k)
        else:
            sizes = [int(x) for x in rng.integers(1, 4000, s)]
            k = int(rng.integers(1, sum(sizes) + 1))
            m = (rng.standard_normal(s) ** 2 * np.exp(
                rng.uniform(-30, 30, s))).astype(np.float32)
            if trial % 4 == 0:
                m[rng.random(s) < 0.5] = 0.0
            if trial == 4:
                m[:] = 0.0
        caps = tal.segment_caps(k, sizes)
        want = np.asarray(_jit_counts(k, sizes, caps)(jnp.asarray(m)))
        got = tal.adaptive_counts(k, sizes, torch.from_numpy(m), caps=caps)
        assert got == want.tolist(), (trial, k, sizes, m)
        assert sum(got) == min(k, sum(sizes))
        checked += 1
    assert checked == 8


def test_dense_moments_bitwise_with_compiled_reference():
    """The top-cap square mass of each segment of dense keys, at caps
    below, at and past XLA's window of 32 (and past 32^2), with -inf
    keys mixed in the ranked pool."""
    rng = np.random.default_rng(7)
    sizes = [3, 40, 1100, 5000, 70000]
    keys = np.abs(rng.standard_normal(sum(sizes)) * np.exp(
        rng.uniform(-8, 8, sum(sizes)))).astype(np.float32)
    keys[rng.random(keys.size) < 0.05] = 0.0
    bounds = tal.layer_segments(sizes, len(sizes))
    for k in (5, 300, 20000):
        caps = tal.segment_caps(k, sizes)
        want = jax.jit(lambda x: jal.dense_segment_moments(x, bounds, caps))(
            jnp.asarray(keys))
        got = tal.dense_segment_moments(torch.from_numpy(keys), bounds, caps)
        assert _eq(want, got), k
        pool = torch.from_numpy(keys[:1100].copy())
        pool[::7] = float("-inf")
        want = jax.jit(lambda x: jnp.sum(jnp.where(x > -jnp.inf, x * x,
                                                   0.0)))(pool.numpy())
        assert _eq(want, tal.square_mass(pool))


def test_validation_matches_reference():
    for fields in (dict(kind="sketchtopk", allocation="adaptive"),
                   dict(kind="none", allocation="proportional"),
                   dict(kind="topk", allocation="adaptive",
                        selector="histogram"),
                   dict(kind="regtopk", allocation="adaptive",
                        state_format="sparse"),
                   dict(kind="topk", allocation="sideways")):
        with pytest.raises(ValueError) as ref:
            jal.check_allocation(JaxSparsifierConfig(**fields))
        with pytest.raises(ValueError) as got:
            tal.check_allocation(SparsifierConfig(**fields))
        assert str(got.value) == str(ref.value)
    tal.check_allocation(SparsifierConfig(kind="randk",
                                          allocation="adaptive",
                                          selector="histogram"))


# ---------------------------------------------------------------------------
# allocated compress, both pipelines
# ---------------------------------------------------------------------------

def _run(fields: dict, mask=None, seed: int = 0, j: int = J, gfn=None,
         steps: int = T):
    """``steps`` steps of the reference's jitted compress +
    observe_aggregate and the port's from zero state on the same
    gradients, aggregates and key: values, indices, count and every
    state tensor bitwise at every step. Returns the port's fallbacks."""
    jcfg, tcfg = JaxSparsifierConfig(**fields), SparsifierConfig(**fields)

    def jax_step(st, g, p, key, g_agg):
        o = jsp.compress(jcfg, st, g, key=key, participate=p)
        new = jsp.observe_aggregate(jcfg, o.state, g_agg, participate=p)
        return o.values, o.indices, o.count, new

    jstep = jax.jit(jax_step)
    jst = jsp.init_state(jcfg, j)
    tst = tsp.init_state(tcfg, j, "cpu")
    jkey, tkey = jax.random.PRNGKey(5), threefry.prng_key(5)
    rng = np.random.default_rng(seed)
    fallbacks = []
    for t in range(steps):
        g = (rng.standard_normal(j).astype(np.float32) if gfn is None
             else gfn(t))
        g_agg = rng.standard_normal(j).astype(np.float32)
        p = None if mask is None else mask[t]
        jv, ji, jc, jst = jstep(jst, jnp.asarray(g), p, jkey,
                                jnp.asarray(g_agg))
        tp = None if p is None else torch.tensor(p)
        out = tsp.compress(tcfg, tst, torch.from_numpy(g), participate=tp,
                           key=tkey)
        tst = tsp.observe_aggregate(tcfg, out.state, torch.from_numpy(g_agg),
                                    participate=tp)
        assert _eq(jv, out.values), t
        assert _eq(ji, out.indices.numpy().view(np.uint32)), t
        if jc is not None:
            # the port's count is None where all k slots are live
            assert int(jc) == (tsp.resolve_k(tcfg, j) if out.count is None
                               else int(out.count)), t
        got = state_to_jax(tst)
        assert sorted(got) == sorted(jst), t
        for key in jst:
            assert _eq(jst[key], got[key]), (t, key)
        fallbacks.append(out.fallback)
    return fallbacks


@pytest.mark.parametrize("pipeline", ["fused", "reference"])
@pytest.mark.parametrize("kind", ["topk", "dgc", "regtopk", "thresholdk",
                                  "randk"])
@pytest.mark.parametrize("allocation", ["proportional", "adaptive"])
def test_allocated_compress_matches_reference(pipeline, kind, allocation):
    """Step 0 and step 1 (REGTOP-k's posterior, DGC's momentum)."""
    _run(dict(BASE, kind=kind, pipeline=pipeline, allocation=allocation),
         steps=2)


@pytest.mark.parametrize("kind", ["dgc", "regtopk"])
@pytest.mark.parametrize("allocation", ["proportional", "adaptive"])
def test_allocated_compress_under_participation(kind, allocation):
    """The worker sits out step 1 (err_decay 0.9): an inert payload, the
    decayed error, DGC's advanced momentum, REGTOP-k's frozen posterior;
    the bit on gives the unmasked path's bits."""
    for pipeline in ("fused", "reference"):
        _run(dict(BASE, kind=kind, pipeline=pipeline, allocation=allocation,
                  err_decay=0.9), mask=MASK)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_adaptive_regtopk_stress(seed):
    """The reference's stress inputs (``tests/test_allocate.py``: mu = 1,
    Q = 1, sparsity 0.1, skewed per-segment magnitudes, 6 segments over
    J = 4000), which send the reference's own fused path (its XLA
    strategy's witnesses) to its dense fallback: bitwise on the port's
    fused pipeline, whose per-tile slots cover them on the fast path."""
    j = 4000

    def gfn(t):
        kk = jax.random.fold_in(jax.random.PRNGKey(100 + seed), t)
        scale = jnp.exp(jnp.sin(jnp.arange(j) * (0.003 + 0.001 * seed))
                        * 2.0)
        return np.asarray(jax.random.normal(kk, (j,)) * scale, np.float32)

    fields = dict(kind="regtopk", pipeline="fused", comm_mode="sparse",
                  allocation="adaptive", num_segments=6, sparsity=0.1,
                  mu=1.0, Q=1.0)
    _run(fields, j=j, gfn=gfn, seed=seed, steps=2)


@pytest.mark.parametrize("kind", ["topk", "regtopk"])
@pytest.mark.parametrize("allocation", ["proportional", "adaptive"])
def test_allocated_fallback_matches_reference(kind, allocation):
    """Inputs that overflow a segment's candidate slots: a run of equal
    magnitudes (a tie of thousands at the threshold) in the middle
    segment. The port's allocated fallback (the dense per-segment
    selection, adaptive counts from the dense moments) runs and is
    bitwise the reference's."""
    rng = np.random.default_rng(11)

    def gfn(t):
        g = rng.standard_normal(J).astype(np.float32)
        g[5000:9000] = np.where(rng.random(4000) < 0.5, 3.0, -3.0)
        return g

    fallbacks = _run(dict(BASE, kind=kind, pipeline="fused",
                          allocation=allocation), gfn=gfn, steps=2)
    assert "overflow" in fallbacks, fallbacks


def test_allocated_fused_matches_reference_pallas_strategy():
    """One step sequence of the reference's fused path through its Pallas
    kernels in interpret mode (``_seg_candidates_pallas``: per-segment
    tau and slots, as the port's), against the port's fused call on the
    same inputs and explicit layer-aligned bounds."""
    bounds = tal.layer_segments([4196, 300, 2500, 0, 990], 3)
    j = sum(size for _, size in bounds)
    k = 150
    rng = np.random.default_rng(3)
    for allocation in ("proportional", "adaptive"):
        st = {"err": np.zeros(j, np.float32)}
        err = torch.zeros(j)
        ref = jax.jit(lambda g, e, t, alloc=allocation:
                      jops.fused_compress_arrays(
                          "topk", g, e, t, k=k, strategy="pallas_interpret",
                          allocation=alloc, seg_bounds=bounds,
                          want_ghat=False))
        for t in range(2):
            g = rng.standard_normal(j).astype(np.float32)
            want = ref(jnp.asarray(g), jnp.asarray(st["err"]), jnp.int32(t))
            got = tops.fused_compress_arrays(
                "topk", torch.from_numpy(g), err, torch.tensor(t), k=k,
                allocation=allocation, seg_bounds=bounds)
            assert _eq(want["values"], got["values"]), (allocation, t)
            assert _eq(want["indices"],
                       got["indices"].numpy().view(np.uint32))
            assert _eq(want["err"], got["err"])
            st["err"], err = np.asarray(want["err"]), got["err"]


def test_explicit_seg_bounds_both_pipelines():
    """Layer-aligned bounds through ``compress(seg_bounds=...)``: the
    reference's own pipelines against each other and the port's."""
    bounds = tal.layer_segments([4000, 100, 2900, 3000], 3)
    j = 10_000
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (j,)))
    outs = {}
    for pipeline in ("reference", "fused"):
        fields = dict(kind="topk", k=200, allocation="proportional",
                      pipeline=pipeline, comm_mode="sparse")
        jcfg, tcfg = JaxSparsifierConfig(**fields), SparsifierConfig(**fields)
        want_v, want_i = jax.jit(lambda st, x, c=jcfg: (lambda o: (
            o.values, o.indices))(jsp.compress(c, st, x, seg_bounds=bounds)))(
                jsp.init_state(jcfg, j), jnp.asarray(g))
        got = tsp.compress(tcfg, tsp.init_state(tcfg, j, "cpu"),
                           torch.from_numpy(g), seg_bounds=bounds)
        assert _eq(want_v, got.values), pipeline
        assert _eq(want_i, got.indices.numpy().view(np.uint32))
        outs[pipeline] = got
    assert torch.equal(outs["reference"].indices, outs["fused"].indices)
    per = [int(((outs["fused"].indices >= o) & (outs["fused"].indices
                                                < o + s)).sum())
           for o, s in bounds]
    assert per == tal.proportional_counts(200, [s for _, s in bounds])


def test_bf16_state_allocated():
    """The bf16 error state under allocation on both pipelines (B1's bf16
    read per segment; the reference pipeline's fp32 keys of the unrounded
    sum)."""
    for pipeline in ("fused", "reference"):
        _run(dict(BASE, kind="topk", pipeline=pipeline,
                  allocation="adaptive", ef_dtype="bfloat16"))
