"""The fused pipeline's capability matrix on the port against the
reference, bitwise: bucketed sweeps (num_buckets 1, 3, 8 at a J that is
not a multiple of the 4096-element tile, so no bucket is either), the
bf16 error state on both pipelines (with elastic participation and
err_decay), the fused histogram selector (its live count, inert pads and
REGTOP-k's ``nsel``), kinds randk and thresholdk on both pipelines with
the same key, B1's bf16 read in its plain version against the Pallas
kernel in interpret mode, and the bf16 state crossing in ``convert``.

The reference runs under ``jax.jit``, as its train step compiles it; on
the CPU its fused pipeline takes the XLA strategy, and the bucketed
Pallas path runs in interpret mode where a test says so. Each step feeds
``observe_aggregate`` a fresh Gaussian g_agg, so REGTOP-k's posterior is
exercised."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SparsifierConfig as JaxSparsifierConfig  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.kernels.compress import kernel as jpk  # noqa: E402
from repro.kernels.compress import ops as jops  # noqa: E402
from repro_torch.configs.base import SparsifierConfig  # noqa: E402
from repro_torch.convert import state_from_jax, state_to_jax  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.flatten import bucket_bounds  # noqa: E402
from repro_torch.kernels.compress import kernel as pk  # noqa: E402
from repro_torch.kernels.compress.dispatch import hist_capacity  # noqa: E402

T = 3
J = 3 * 4096 + 1000          # ragged: 3 or 8 buckets are not tile multiples
MU = 0.5
MASK = (True, False, True)   # participation: the worker sits out step 1
FUSED = dict(pipeline="fused", comm_mode="sparse", sparsity=0.01, mu=MU)
REFERENCE = dict(pipeline="reference", comm_mode="simulate", sparsity=0.01,
                 mu=MU)


def _bits(x):
    """Bit patterns of a numpy array or a tensor (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    if x.dtype in (np.float32, np.uint32):
        return x.view(np.int32)
    return x


def _eq(want, got) -> bool:
    return np.array_equal(_bits(want), _bits(got))


def _run(fields: dict, mask=None, seed: int = 0):
    """T steps of the reference's jitted compress + observe_aggregate and
    the port's, from zero state on the same gradients, aggregates and
    key: every output and the whole state bitwise at every step. Returns
    the port's outputs."""
    jcfg, tcfg = JaxSparsifierConfig(**fields), SparsifierConfig(**fields)

    def jax_step(st, g, p, key, g_agg):
        o = jsp.compress(jcfg, st, g, key=key, participate=p)
        new = jsp.observe_aggregate(jcfg, o.state, g_agg, participate=p)
        return o.values, o.indices, o.count, new

    jstep = jax.jit(jax_step)
    jst = jsp.init_state(jcfg, J)
    tst = tsp.init_state(tcfg, J, "cpu")
    jkey, tkey = jax.random.PRNGKey(5), threefry.prng_key(5)
    rng = np.random.default_rng(seed)
    outs = []
    for t in range(T):
        g = rng.standard_normal(J).astype(np.float32)
        g_agg = rng.standard_normal(J).astype(np.float32)
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
        if jc is not None and out.count is not None:
            assert int(jc) == int(out.count), t
        got = state_to_jax(tst)
        assert sorted(got) == sorted(jst), t
        for key in jst:
            assert got[key].dtype == np.asarray(jst[key]).dtype, (t, key)
            assert _eq(jst[key], got[key]), (t, key)
        outs.append(out)
    return outs


@pytest.mark.parametrize("kind", ["topk", "dgc", "regtopk"])
@pytest.mark.parametrize("nb", [1, 3, 8])
def test_fused_buckets_match_reference(kind, nb):
    assert any(size % pk.BLOCK for _, size in bucket_bounds(J, nb))
    _run(dict(FUSED, kind=kind, num_buckets=nb))


@pytest.mark.parametrize("kind", ["topk", "dgc", "regtopk"])
@pytest.mark.parametrize("nb", [1, 3, 8])
def test_bucketed_selection_equals_flat(kind, nb):
    """The port's bucketed call against its own flat call (bf16 state,
    so the per-bucket views of the bf16 read are exercised too):
    values, indices, count and every state tensor bit for bit."""
    flat = SparsifierConfig(kind=kind, ef_dtype="bfloat16", **FUSED)
    cut = dataclasses.replace(flat, num_buckets=nb)
    st_f, st_b = (tsp.init_state(c, J, "cpu") for c in (flat, cut))
    rng = np.random.default_rng(3)
    for t in range(T):
        g = torch.from_numpy(rng.standard_normal(J).astype(np.float32))
        ga = torch.from_numpy(rng.standard_normal(J).astype(np.float32))
        of, ob = tsp.compress(flat, st_f, g), tsp.compress(cut, st_b, g)
        assert _eq(of.values, ob.values) and _eq(of.indices, ob.indices)
        st_f = tsp.observe_aggregate(flat, of.state, ga)
        st_b = tsp.observe_aggregate(cut, ob.state, ga)
        for key in st_f:
            assert st_f[key].dtype == st_b[key].dtype
            assert _eq(st_f[key], st_b[key]), (t, key)


def test_bucketed_pallas_interpret_matches_port():
    """The reference's bucketed Pallas path itself (per-bucket padded
    sweeps, bin-0 pad correction, merged histogram, per-bucket sweep 2),
    in interpret mode, fed the port's pre-step state: 3 buckets of a
    ragged J, REGTOP-k over T steps."""
    cfg = SparsifierConfig(kind="regtopk", num_buckets=3, **FUSED)
    k = tsp.resolve_k(cfg, J)
    jfn = jax.jit(lambda g, st: jops.fused_compress_arrays(
        "regtopk", g, st["err_prev"], st["step"], k=k, mu=MU,
        idx_prev=st["idx_prev"], a_prev_sel=st["a_prev_sel"],
        g_prev_sel=st["g_prev_sel"], want_ghat=False, num_buckets=3,
        strategy="pallas_interpret"))
    st = tsp.init_state(cfg, J, "cpu")
    rng = np.random.default_rng(8)
    for t in range(T):
        g = rng.standard_normal(J).astype(np.float32)
        want = jfn(jnp.asarray(g), jax.device_get(state_to_jax(st)))
        out = tsp.compress(cfg, st, torch.from_numpy(g))
        assert _eq(want["values"], out.values), t
        assert _eq(want["indices"], out.indices.numpy().view(np.uint32)), t
        assert _eq(want["err"], out.state["err_prev"]), t
        st = tsp.observe_aggregate(
            cfg, out.state,
            torch.from_numpy(rng.standard_normal(J).astype(np.float32)))


@pytest.mark.parametrize("pipeline,kind,nb", [
    ("fused", "topk", 1), ("fused", "dgc", 3), ("fused", "regtopk", 8),
    ("reference", "topk", 1), ("reference", "dgc", 1),
    ("reference", "thresholdk", 1), ("reference", "randk", 1)])
def test_bf16_state_matches_reference(pipeline, kind, nb):
    """ef_dtype="bfloat16" under participation (1, 0, 1) with err_decay
    0.9: the state stays bf16, a sitting-out worker's decayed error is
    rounded to bf16, and everything matches the reference bitwise."""
    base = FUSED if pipeline == "fused" else REFERENCE
    outs = _run(dict(base, kind=kind, ef_dtype="bfloat16", err_decay=0.9,
                     num_buckets=nb), mask=MASK)
    assert outs[-1].state[tsp.err_key(SparsifierConfig(
        pipeline=pipeline))].dtype == torch.bfloat16
    assert int(outs[1].count) == 0


@pytest.mark.parametrize("kind,extra,mask", [
    ("topk", {}, None), ("dgc", {"num_buckets": 3}, None),
    ("regtopk", {}, None),
    ("regtopk", {"ef_dtype": "bfloat16", "err_decay": 0.9,
                 "num_buckets": 8}, MASK)])
def test_histogram_selector_matches_reference(kind, extra, mask):
    """The fused histogram selector: bitwise with the reference, a live
    count in [k, hist_capacity] (0 for a sitting-out worker), inert pads
    past it (value 0.0 at index 0), REGTOP-k's ``nsel`` equal to the
    count and its capacity-sized posterior."""
    fields = dict(FUSED, kind=kind, selector="histogram", **extra)
    outs = _run(fields, mask=mask)
    cfg = SparsifierConfig(**fields)
    k = tsp.resolve_k(cfg, J)
    kcap = hist_capacity(k, J)
    for t, out in enumerate(outs):
        n = int(out.count)
        assert out.values.numel() == kcap == 2 * k
        if mask is not None and not mask[t]:
            assert n == 0
        else:
            assert k <= n <= kcap
        assert not out.values[n:].any() and not out.indices[n:].any()
        assert (out.values[:n] != 0).all()
        if kind == "regtopk":
            assert int(out.state["nsel"]) == (n if mask is None or mask[t]
                                              else int(outs[t - 1].count))
            assert out.state["idx_prev"].numel() == kcap


@pytest.mark.parametrize("pipeline", ["fused", "reference"])
@pytest.mark.parametrize("kind", ["randk", "thresholdk"])
def test_randk_thresholdk_match_reference(pipeline, kind):
    base = FUSED if pipeline == "fused" else REFERENCE
    _run(dict(base, kind=kind), mask=MASK if kind == "randk" else None)


@pytest.mark.parametrize("seed,j,k", [(0, 1000, 10), (3, 70_000, 700),
                                      (11, 5000, 4999)])
def test_randk_indices_match_reference(seed, j, k):
    """jax.random.bits' partitionable stream and randk_indices' top-k of
    it, at a J past one chunk of the port's stream where it is 70,000."""
    from repro.core import select as jsel
    from repro_torch.core import select as tsel
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    tkey = threefry.fold_in(threefry.prng_key(seed), 2)
    bits = np.asarray(jax.random.bits(jkey, (j,), jnp.uint32))
    assert np.array_equal(bits.astype(np.int64),
                          threefry.random_bits32_range(tkey, 0, j).numpy())
    want = jax.jit(lambda key: jsel.randk_indices(key, j, k))(jkey)
    assert np.array_equal(np.asarray(want).astype(np.int64),
                          tsel.randk_indices(tkey, j, k).numpy())


@pytest.mark.parametrize("mode,p", [
    ("plain", True), ("dgc", True), ("gated", True), ("gated", False),
    ("gated_dgc", True), ("gated_dgc", False)])
def test_sweep1_bf16_read_matches_pallas(mode, p):
    """B1's bf16 read (its plain version, which the card's kernel equals
    bit for bit in chip_smoke.py) against the reference's padded Pallas
    slice in interpret mode on a bf16 state and a gradient cast to bf16,
    as the reference's compress casts it: a, score, mom' and the
    histogram (after the reference's bin-0 pad correction). Gated modes
    run the reference's masked inputs first (the decayed error rounded
    to bf16); p=False sits the worker out."""
    dgc = mode.endswith("dgc")
    n = 2 * 4096 + 517
    rng = np.random.default_rng(21)
    g = rng.standard_normal(n).astype(np.float32)
    err = (rng.standard_normal(n) * 0.1).astype(np.float32)
    err[::97] = -0.0
    mom = rng.standard_normal(n).astype(np.float32)
    g16, err16, mom16 = (jnp.asarray(x).astype(jnp.bfloat16)
                         for x in (g, err, mom))
    c = jnp.float32(0.75)
    gate = None
    if mode.startswith("gated"):
        g16, err16, gate = jops.masked_inputs(g16, err16, jnp.asarray(p), 0.9)
    want = jax.jit(lambda g_, e_, m_, gt: jops._sweep1_slice(
        "dgc" if dgc else "topk", g_, e_, c, momentum=0.9,
        mom_s=m_ if dgc else None, interpret=True,
        gate=gt if dgc else None))(g16, err16, mom16, gate)
    tg = torch.from_numpy(g)
    terr = torch.from_numpy(err).to(torch.bfloat16)
    tmom = torch.from_numpy(mom).to(torch.bfloat16) if dgc else None
    tc = torch.full((1,), 0.75)
    if mode.startswith("gated"):
        got = pk.sweep1_gated(tg, terr, tc, torch.full((1,), float(p)), 0.9,
                              tmom, 0.9)
    else:
        got = pk.sweep1(tg, terr, tc, tmom, 0.9)
    assert _eq(want[0], got[0])
    assert _eq(np.asarray(want[1])[:n], got[1])
    assert _eq(want[3], got[3])
    if dgc:
        assert _eq(want[2], got[4])


def test_threshold_from_bucket_hists_matches_reference():
    rng = np.random.default_rng(2)
    hists = [rng.integers(0, 50, pk.BINS).astype(np.int32) for _ in range(5)]
    for target in (1, 100, 7_000, 10 ** 6):
        want = jpk.threshold_from_bucket_hists([jnp.asarray(h) for h in hists],
                                               target)
        got = pk.threshold_from_bucket_hists([torch.from_numpy(h)
                                              for h in hists], target)
        assert _eq(np.asarray(want).reshape(1), got)


def test_state_crossing_bf16():
    """A bf16 state from the reference crosses into the port and back bit
    for bit, keeping its dtypes (the uint16 view); REGTOP-k's fused
    histogram layout, nsel and the capacity-sized posterior included."""
    cfg = JaxSparsifierConfig(kind="regtopk", selector="histogram",
                              ef_dtype="bfloat16", **FUSED)
    rng = np.random.default_rng(4)
    st = {key: np.asarray(val) for key, val in
          jax.device_get(jsp.init_state(cfg, 5000)).items()}
    for key in ("err_prev", "a_prev_sel", "g_prev_sel"):
        st[key] = np.asarray(jnp.asarray(rng.standard_normal(
            st[key].shape).astype(np.float32)).astype(jnp.bfloat16))
    st["idx_prev"] = rng.integers(0, 2 ** 32 - 1, st["idx_prev"].shape,
                                  dtype=np.uint32)
    st["nsel"] = np.int32(73)
    tst = state_from_jax(st)
    assert tst["err_prev"].dtype == torch.bfloat16
    assert sorted(tst) == sorted(
        tsp.init_state(SparsifierConfig(kind="regtopk", selector="histogram",
                                        ef_dtype="bfloat16", **FUSED),
                       5000, "cpu"))
    back = state_to_jax(tst)
    for key in st:
        assert back[key].dtype == np.asarray(st[key]).dtype, key
        assert _eq(st[key], back[key]), key
