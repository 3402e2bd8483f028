"""Streaming compression (``overlap="backward"``) on the port: the stream
against the flat call, against the reference's streaming compress, its
lifecycle errors, the leaf-aligned segments, and the train step that
feeds the stream from hooks during the backward pass against the
reference's train step.

Streaming is bitwise with the flat call for allocation global,
proportional and adaptive at one and four buckets, under participation,
with the segments fed in the backward pass's order (last first) and in
order without a known partition; g_agg and every state tensor are
compared as bit patterns. The train steps are held to
``tests/test_torch_train.py``'s tolerances (loss rtol 1e-5, params atol
1e-5) and the selected supports must be equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.core.flatten import TreeFlattener as JaxFlattener  # noqa: E402
from repro.kernels.compress.dispatch import check_overlap as jcheck  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import state_to_jax  # noqa: E402
from repro_torch.core import aggregate, allocate, sparsify  # noqa: E402
from repro_torch.core.flatten import TreeFlattener  # noqa: E402
from repro_torch.kernels.compress import ops  # noqa: E402
from repro_torch.kernels.compress.dispatch import check_overlap  # noqa: E402

J = 3 * 4096 + 1000
MASK = (True, False, True)
LEAVES = [700, 0, 3000, 4096, 1, 2599, 0, 1900, 992]   # J in all
BOUNDS = allocate.layer_segments(LEAVES, 5)
assert sum(LEAVES) == J


def _cfg(allocation, nb, **kw):
    return tbase.SparsifierConfig(
        kind=kw.pop("kind", "regtopk"), pipeline="fused", comm_mode="sparse",
        sparsity=0.01, mu=0.5, allocation=allocation, num_buckets=nb,
        overlap="backward", err_decay=0.9, **kw)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return torch.equal(a, b)
    return a == b


def _states_equal(x: dict, y: dict) -> bool:
    return set(x) == set(y) and all(_same(x[k], y[k]) for k in x)


@pytest.mark.parametrize("allocation", ["global", "proportional",
                                        "adaptive"])
@pytest.mark.parametrize("nb", [1, 4])
@pytest.mark.parametrize("kind", ["regtopk", "dgc"])
def test_stream_is_the_flat_call(allocation, nb, kind):
    """Three steps, the worker sitting out step 1: a stream fed last
    segment first (the backward pass's order) on the layer-aligned
    partition, a stream of a sync built without one fed in order (the
    reference's form; its partition is the flat call's default), and
    the flat call of the same config with overlap="none": g_agg and the
    state bit for bit."""
    cfg = _cfg(allocation, nb, kind=kind)
    flat_cfg = dataclasses.replace(cfg, overlap="none")
    seg = BOUNDS if allocation != "global" else None
    sync = aggregate.GradientSync(cfg, seg_bounds=seg, stream_bounds=BOUNDS)
    late = aggregate.GradientSync(cfg, seg_bounds=seg)
    flat = aggregate.GradientSync(flat_cfg, seg_bounds=seg)
    st = [sparsify.init_state(cfg, J, "cpu") for _ in range(3)]
    rng = np.random.default_rng(0)
    for t in range(3):
        g = torch.from_numpy(rng.standard_normal(J).astype(np.float32))
        p = torch.tensor(MASK[t])
        stream = sync.begin(st[0], participate=p)
        for off, size in reversed(BOUNDS):
            stream.feed_segment(g[off:off + size].clone(), offset=off)
        got = stream.finish(with_stats=True)
        stream = late.begin(st[1], participate=p)
        for off, size in sparsify.partitions(cfg, J, seg)[1]:
            stream.feed_segment(g[off:off + size].clone())
        kept = stream.finish(with_stats=True)
        want = flat(st[2], g, participate=p, with_stats=True)
        for out in (got, kept):
            assert _same(out[0], want[0]), t
            assert _states_equal(out[1], want[1]), t
            assert _states_equal(out[2], want[2]), t
        st = [got[1], kept[1], want[1]]


def test_stream_matches_reference_streaming_compress():
    """The port's stream against the reference's compress with
    ``g_segments`` (jitted), adaptive allocation on the layer-aligned
    partition: values, indices and the state bitwise over three steps."""
    fields = dict(kind="regtopk", pipeline="fused", comm_mode="sparse",
                  sparsity=0.01, mu=0.5, allocation="adaptive",
                  overlap="backward")
    jcfg, tcfg = jbase.SparsifierConfig(**fields), \
        tbase.SparsifierConfig(**fields)

    def jstep(st, segs, g_agg):
        o = jsp.compress(jcfg, st, None, g_segments=segs)
        return o.values, o.indices, jsp.observe_aggregate(jcfg, o.state,
                                                          g_agg)
    jfn = jax.jit(jstep)
    jst = jsp.init_state(jcfg, J)
    tst = sparsify.init_state(tcfg, J, "cpu")
    rng = np.random.default_rng(1)
    for t in range(3):
        g = rng.standard_normal(J).astype(np.float32)
        g_agg = rng.standard_normal(J).astype(np.float32)
        jv, ji, jst = jfn(jst, [jnp.asarray(g[o:o + s]) for o, s in BOUNDS],
                          jnp.asarray(g_agg))
        step = sparsify.begin_fused(tcfg, tst, J, seg_bounds=BOUNDS,
                                    stream_bounds=BOUNDS)
        for pos in reversed(range(len(BOUNDS))):
            off, size = BOUNDS[pos]
            step.feed(pos, torch.from_numpy(g[off:off + size]))
        out = step.finish()
        tst = sparsify.observe_aggregate(tcfg, out.state,
                                         torch.from_numpy(g_agg))
        assert np.array_equal(np.asarray(jv).view(np.int32),
                              out.values.numpy().view(np.int32)), t
        assert np.array_equal(np.asarray(ji),
                              out.indices.numpy().view(np.uint32)), t
        got = state_to_jax(tst)
        for key in jst:
            assert np.array_equal(np.asarray(jst[key]).view(np.int32),
                                  np.asarray(got[key]).view(np.int32)), key


def test_stream_lifecycle_errors():
    cfg = _cfg("adaptive", 1)
    st = sparsify.init_state(cfg, J, "cpu")
    g = torch.zeros(J)
    with pytest.raises(ValueError, match="overlap='backward'"):
        aggregate.GradientSync(dataclasses.replace(cfg, overlap="none")
                               ).begin(st)
    sync = aggregate.GradientSync(cfg, seg_bounds=BOUNDS)
    with pytest.raises(ValueError, match="no fed segments"):
        sync.begin(st).finish()
    stream = sync.begin(st)
    with pytest.raises(ValueError, match="offset 5"):
        stream.feed_segment(g[5:700], offset=5)
    for off, size in BOUNDS[:-1]:
        stream.feed_segment(g[off:off + size], offset=off)
    with pytest.raises(RuntimeError, match="never fed"):
        stream.finish()
    stream = sync.begin(st)
    for off, size in BOUNDS:
        stream.feed_segment(g[off:off + size])
    with pytest.raises(RuntimeError, match="fed twice"):
        stream.feed_segment(g[:BOUNDS[0][1]], offset=0)
    stream.finish()
    with pytest.raises(RuntimeError, match="after finish"):
        stream.feed_segment(g[:BOUNDS[0][1]])
    with pytest.raises(RuntimeError, match="twice"):
        stream.finish()
    with pytest.raises(ValueError, match="seg_bounds == the g_segments"):
        sparsify.compress(cfg, st, None, seg_bounds=BOUNDS[:1] + [
            (BOUNDS[0][1], J - BOUNDS[0][1])],
            g_segments=[g[o:o + s] for o, s in BOUNDS])
    with pytest.raises(ValueError, match="not both"):
        sparsify.compress(cfg, st, g, g_segments=[g])
    with pytest.raises(ValueError, match="tile"):
        ops.FusedStep("topk", torch.zeros(J), torch.tensor(0), k=10,
                      bounds=[(0, 10)])


@pytest.mark.parametrize("fields", [
    dict(kind="sketchtopk", pipeline="fused"),
    dict(kind="regtopk", pipeline="reference"),
    dict(kind="none", pipeline="fused"),
    dict(kind="topk", pipeline="fused", overlap="sideways")])
def test_check_overlap_matches_reference(fields):
    fields = dict(dict(overlap="backward"), **fields)
    with pytest.raises(ValueError) as ref:
        jcheck(jbase.SparsifierConfig(**fields))
    with pytest.raises(ValueError) as got:
        check_overlap(tbase.SparsifierConfig(**fields))
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError):
        aggregate.GradientSync(tbase.SparsifierConfig(**fields))


def test_segments_of_a_tree_match_reference():
    """layer_bounds and flatten_segments of the reduced model's tree
    (tied embeddings, so one leaf fewer) against the reference's
    flattener, and flatten_segments' refusals."""
    from repro_torch.models import init_params
    cfg = dataclasses.replace(tbase.reduced_config(
        tbase.get_config("starcoder2-7b")), tie_embeddings=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tflat = TreeFlattener(params)
    jflat = JaxFlattener(jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.numpy()), params))
    assert tflat.layer_bounds() == jflat.layer_bounds()
    bounds = allocate.layer_segments(tflat.layer_bounds(), 8)
    segs = tflat.flatten_segments(params, bounds)
    want = jflat.flatten_segments(jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.numpy()), params), bounds)
    assert [s.numel() for s in segs] == [size for _, size in bounds]
    for got, ref in zip(segs, want):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(torch.cat(segs), tflat.flatten(params))
    off0, size0 = bounds[0]
    with pytest.raises(ValueError, match="leaf-aligned"):
        tflat.flatten_segments(params, [(1, tflat.total - 1)])
    with pytest.raises(ValueError, match="cuts inside a leaf"):
        tflat.flatten_segments(params, [(0, tflat.sizes[0] + 1)])
    with pytest.raises(ValueError, match="cover every leaf"):
        tflat.flatten_segments(params, [(off0, size0)])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-5             # tests/test_torch_train.py's
PARAM_ATOL = 1e-5


def _run_cfg(mod, arch="stablelm-3b", tied=False, **sp):
    cfg = mod.reduced_config(mod.get_config(arch))
    if tied:
        cfg = dataclasses.replace(cfg, tie_embeddings=True, rope=False)
    return mod.RunConfig(
        model=cfg, shape=mod.SHAPES["train_4k"],
        sparsifier=mod.SparsifierConfig(
            kind="regtopk", sparsity=0.01, mu=0.5, comm_mode="sparse",
            pipeline="fused", **sp),
        optimizer=mod.OptimizerConfig(kind="adam", lr=1e-3), seed=0,
        steps=3)


@pytest.mark.parametrize("arch,tied", [("stablelm-3b", False),
                                       ("starcoder2-7b", True)])
def test_three_streamed_steps_match_reference(arch, tied):
    """allocation="adaptive", overlap="backward": three steps of the
    port's train step (hooks feed the stream) against the reference's
    (its segments fed from the VJP), from the same weights on one fixed
    batch. Loss and params within the tolerances above, the selected
    support equal at every step, gnorm_local (the per-segment form)
    within the loss tolerance; the port's error state equals that of its
    own flat step (overlap="none") bit for bit. On the tied layout every
    leaf's hook fires once, the shared embedding's with the sum of its
    two uses."""
    from repro.launch.mesh import make_mesh
    from repro.train.step import build_parallel
    from repro.train.step import build_train_step as jbuild
    from repro.train.step import init_train_state as jinit
    from repro_torch.convert import params_from_jax
    from repro_torch.train.step import build_train_step, init_train_state
    sp = dict(allocation="adaptive", overlap="backward")
    jrun, trun = _run_cfg(jbase, arch, tied, **sp), \
        _run_cfg(tbase, arch, tied, **sp)
    flat_run = dataclasses.replace(trun, sparsifier=dataclasses.replace(
        trun.sparsifier, overlap="none"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 32)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((4, 1), np.int32)], 1)
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    with mesh:
        params, opt, ef = jinit(jrun, mesh, pal, jax.random.PRNGKey(0))
        step_fn, _, _ = jbuild(jrun, mesh, pal)
        jstep = jax.jit(step_fn)
        tparams = params_from_jax(jax.device_get(params))
        tstate = init_train_state(trun, "cpu", params=tparams)
        fstate = init_train_state(flat_run, "cpu", params=tparams)
        tstep = build_train_step(trun, "cpu")
        fstep = build_train_step(flat_run, "cpu")
        assert tstep.stream_bounds == tstep.seg_bounds == \
            tstep.gsync.stream_bounds
        fired = []
        real_hook = torch.Tensor.register_hook

        def counting(leaf, fn):
            def wrapped(grad):
                fired.append(id(leaf))
                return fn(grad)
            return real_hook(leaf, wrapped)
        jbatch = {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)}
        tbatch = {"tokens": torch.from_numpy(tokens).long(),
                  "targets": torch.from_numpy(targets).long()}
        for t in range(3):
            params, opt, ef, metrics = jstep(params, opt, ef, jbatch,
                                             jax.random.PRNGKey(0))
            fired.clear()
            torch.Tensor.register_hook = counting
            try:
                n_leaves = len(TreeFlattener(tstate.params).sizes)
                tstate, tmetrics = tstep(tstate, tbatch)
            finally:
                torch.Tensor.register_hook = real_hook
            assert len(fired) == len(set(fired)) == n_leaves, t
            fstate, _ = fstep(fstate, tbatch)
            np.testing.assert_allclose(float(tmetrics["loss"]),
                                       float(metrics["loss"]),
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(float(tmetrics["gnorm_local"]),
                                       float(metrics["gnorm_local"]),
                                       rtol=LOSS_RTOL)
            want = np.sort(np.asarray(ef["idx_prev"]).reshape(-1))
            got = np.sort(tstate.ef["idx_prev"].numpy().view(np.uint32))
            assert np.array_equal(want, got), t
            assert _states_equal(tstate.ef, fstate.ef), t
        jflat = np.asarray(JaxFlattener(params).flatten(params))
    tflat = TreeFlattener(tstate.params).flatten(tstate.params)
    np.testing.assert_allclose(tflat.detach().numpy(), jflat, rtol=0,
                               atol=PARAM_ATOL)


def test_launcher_flags():
    """--allocation, --num-segments and --overlap with the reference
    launcher's choices and defaults, into the run's SparsifierConfig."""
    from repro.launch.train import parse_args as jparse
    from repro_torch.launch.train import parse_args, run_config
    base = ["--arch", "stablelm-3b", "--smoke"]
    for extra in ([], ["--allocation", "adaptive", "--num-segments", "5",
                       "--overlap", "backward", "--pipeline", "fused"]):
        got, want = parse_args(base + extra), jparse(base + extra)
        for name in ("allocation", "num_segments", "overlap"):
            assert getattr(got, name) == getattr(want, name)
        sp = run_config(got).sparsifier
        assert (sp.allocation, sp.num_segments, sp.overlap) == (
            got.allocation, got.num_segments, got.overlap)
    for bad in (["--allocation", "layered"], ["--overlap", "forward"]):
        with pytest.raises(SystemExit):
            parse_args(base + bad)
