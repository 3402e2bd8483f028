"""The dense and genie baselines (kinds ``none`` and ``globaltopk``,
``comm_mode="dense"``) and the in-process round drivers of the port
against the reference: ``make_round_fn`` over stacked states, ``round``
and ``sparsified_round`` with lists, explicit omegas and participation,
the per-step ``GradientSync`` at a world of 1, the ``sync_gradient``
shim, the wire-byte models, and the launcher.

The reference runs under ``jax.jit``, as its drivers run it. Its
``make_round_fn`` sums the workers' ghats with ``jnp.sum(ghats, 0)``,
which XLA's CPU backend reduces in worker order from a +0.0 initial
value (all -0.0 entries sum to +0.0), then multiplies by omega; the
port's round function does the same, so g_agg and every state are
bitwise. XLA rewrites a division by a constant into a multiply by its
fp32 reciprocal: the genie's and the sketch's ``/ jnp.float32(n)`` at
N = 20 is a multiply, and so is the port's."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import aggregate as jagg  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import state_from_jax, state_to_jax  # noqa: E402
from repro_torch.core import aggregate, sparsify  # noqa: E402
from repro_torch.kernels.compress import dispatch  # noqa: E402

ROUNDS = 10
MU = 0.5
ROUND_KINDS = ("topk", "regtopk", "sketchtopk", "globaltopk", "none")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _same(want, got, zero_sign=True):
    """Bitwise; up to the sign of zero when ``zero_sign`` is False."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if not zero_sign:
        want, got = want + np.float32(0.0), got + np.float32(0.0)
    return np.array_equal(_bits(want), _bits(got))


def _cfgs(**kw):
    kw = dict(dict(kind="regtopk", sparsity=0.6, mu=MU,
                   pipeline="reference", comm_mode="simulate"), **kw)
    return jbase.SparsifierConfig(**kw), tbase.SparsifierConfig(**kw)


def _same_state(jst, tst, ctx):
    got = state_to_jax(tst)
    assert set(got) == set(jst), ctx
    for key, val in got.items():
        assert _same(np.asarray(jst[key]), val), (ctx, key)


def _gauss(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# make_round_fn over stacked states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,j,sparsity", [(20, 100, 0.6), (8, 1000, 0.01)])
@pytest.mark.parametrize("kind", ROUND_KINDS)
def test_round_fn_matches_reference(kind, n, j, sparsity):
    """The port's make_round_fn against the reference's jitted one, 10
    rounds from the same stacked states (converted), bitwise: g_agg and
    every stacked state vector. fig2's shape (N = 20, J = 100) and a
    sparser one (N = 8, J = 1000, k = 10)."""
    jcfg, tcfg = _cfgs(kind=kind, sparsity=sparsity)
    jfn = jsp.make_round_fn(jcfg, n)
    tfn = sparsify.make_round_fn(tcfg, n)
    jst = jsp.stack_states([jsp.init_state(jcfg, j) for _ in range(n)])
    tst = state_from_jax(jax.device_get(jst))
    ref = sparsify.stack_states([sparsify.init_state(tcfg, j, "cpu")
                                 for _ in range(n)])
    _same_state(state_to_jax(ref), tst, "init")
    rng = np.random.default_rng(n + j)
    for t in range(ROUNDS):
        grads = _gauss(rng, n, j)
        jg, jst = jfn(jst, jnp.asarray(grads))
        tg, tst = tfn(tst, torch.from_numpy(grads))
        assert _same(jg, tg), (kind, t)
        _same_state(jax.device_get(jst), tst, (kind, t))


def test_stack_states_round_trips():
    _, tcfg = _cfgs()
    states = [sparsify.init_state(tcfg, 7, "cpu") for _ in range(3)]
    states[1]["err"] += 1.0
    stacked = sparsify.stack_states(states)
    assert stacked["err"].shape == (3, 7) and stacked["step"].shape == (3,)
    back = sparsify.unstack_states(stacked, 3)
    for a, b in zip(states, back):
        assert set(a) == set(b)
        for key in a:
            assert torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# round() and sparsified_round with lists
# ---------------------------------------------------------------------------

def _jax_round(cfg, states, grads, omegas=None, participate=None):
    return jax.jit(lambda s, g, p: jagg.GradientSync(cfg, None).round(
        s, g, omegas=omegas, participate=p))(
        states, [jnp.asarray(x) for x in grads],
        None if participate is None else [jnp.asarray(b)
                                          for b in participate])


ROUND_CASES = [
    ("topk", dict()), ("regtopk", dict()), ("none", dict()),
    ("globaltopk", dict()), ("sketchtopk", dict()),
    ("regtopk", dict(omegas=[0.5, 0.3, 0.2])),
    ("globaltopk", dict(omegas=[0.5, 0.3, 0.2])),
    ("none", dict(omegas=[0.5, 0.3, 0.2])),
    ("globaltopk", dict(participate=[True, False, True])),
    ("globaltopk", dict(participate=[False, False, False])),
    ("none", dict(participate=[True, False, True])),
    ("globaltopk", dict(selector="histogram")),
]


@pytest.mark.parametrize("case", range(len(ROUND_CASES)))
def test_round_matches_reference(case):
    """round() (through sparsified_round) over 3 in-process workers
    against the reference's jitted GradientSync.round, 10 rounds,
    bitwise: equal weights, explicit omegas (which the elastic combine
    does not take) and participation bits, and the genie's histogram
    selector. With that selector the reference's mask is
    ``(|a| >= tau).astype(f32)`` and XLA rewrites ``mask * a_agg`` into a
    select, so its unselected entries are +0.0 where the port's multiply
    gives -0.0 (a < 0): g_agg is compared up to the sign of zero there.
    Weights that are not powers of two (1/3, and 0.3, 0.2) check the
    compiled reference's fused multiply-adds in ``sum(w * ghat)``."""
    kind, kw = ROUND_CASES[case]
    kw = dict(kw)
    selector = kw.pop("selector", "exact")
    jcfg, tcfg = _cfgs(kind=kind, selector=selector, sparsity=0.05)
    n, j = 3, 500
    jstates = [jsp.init_state(jcfg, j) for _ in range(n)]
    tstates = [state_from_jax(jax.device_get(s)) for s in jstates]
    rng = np.random.default_rng(case)
    part = kw.get("participate")
    for t in range(ROUNDS):
        grads = [_gauss(rng, j) for _ in range(n)]
        jg, jstates = _jax_round(jcfg, jstates, grads, kw.get("omegas"),
                                 part)
        tg, tstates = sparsify.sparsified_round(
            tcfg, tstates, [torch.from_numpy(g) for g in grads],
            omegas=kw.get("omegas"),
            participate=None if part is None else [torch.tensor(b)
                                                   for b in part])
        assert _same(jg, tg, selector == "exact"), (case, t)
        for js, ts in zip(jstates, tstates):
            _same_state(jax.device_get(js), ts, (case, t))
    if part is not None and not any(part):
        assert not bool(tg.any())          # all absent: g_agg = 0


def test_genie_refuses_omegas_with_a_mask():
    """Explicit omegas with a participation mask are not defined for the
    genie: both packages raise the same ValueError."""
    jcfg, tcfg = _cfgs(kind="globaltopk")
    grads = [np.ones(8, np.float32)] * 2
    with pytest.raises(ValueError, match="not defined for the genie") as want:
        jagg.GradientSync(jcfg, None).round(
            [jsp.init_state(jcfg, 8)] * 2, [jnp.asarray(g) for g in grads],
            omegas=[0.5, 0.5], participate=[True, False])
    with pytest.raises(ValueError, match="not defined for the genie") as got:
        sparsify.sparsified_round(
            tcfg, [sparsify.init_state(tcfg, 8, "cpu")] * 2,
            [torch.from_numpy(g) for g in grads], omegas=[0.5, 0.5],
            participate=[True, False])
    assert str(got.value) == str(want.value)


def test_baselines_compress_and_state():
    """kind none compresses to the gradient under an all-ones mask (both
    zero when the worker sits out); the genie's compress raises, as the
    reference's does; both keep ``step`` only, on either pipeline."""
    for pipeline in ("reference", "fused"):
        for kind in ("none", "globaltopk"):
            jcfg, tcfg = _cfgs(kind=kind, pipeline=pipeline)
            st = sparsify.init_state(tcfg, 5, "cpu")
            assert set(st) == set(jsp.init_state(jcfg, 5)) == {"step"}
    _, tcfg = _cfgs(kind="none", pipeline="fused")
    g = torch.arange(5.0) - 2.0
    out = sparsify.compress(tcfg, {"step": torch.zeros((), dtype=torch.int32)},
                            g)
    assert torch.equal(out.ghat, g) and torch.equal(out.mask, torch.ones(5))
    assert int(out.state["step"]) == 1
    off = sparsify.compress(tcfg, out.state, g, participate=torch.tensor(False))
    assert not bool(off.ghat.any()) and not bool(off.mask.any())
    _, genie = _cfgs(kind="globaltopk")
    with pytest.raises(RuntimeError, match="aggregate-level"):
        sparsify.compress(genie, {"step": torch.zeros(())}, g)


# ---------------------------------------------------------------------------
# the per-step sync at a world of 1
# ---------------------------------------------------------------------------

J = 3 * 4096 + 517
STEPS = 3


def _jax_sync(cfg, st, elastic):
    mesh = jax.make_mesh((1,), ("data",))

    def f(g_, st_, p_):
        return jagg.GradientSync(cfg, ("data",))(
            st_, g_, participate=p_ if elastic else None, with_stats=True)

    spec = jax.tree_util.tree_map(lambda _: P(), st)
    stats = {"n_active": P(), "dropped_nonfinite": P()}
    with mesh:
        return mesh, jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("data"), spec, P()),
            out_specs=(P("data"), spec, stats), check_vma=False))


SYNC_CASES = [(kind, mask, selector)
              for kind in ("none", "globaltopk")
              for mask in (None, (True, False, True))
              for selector in (("exact", "histogram") if kind == "globaltopk"
                               else ("exact",))]


@pytest.mark.parametrize("kind,mask,selector", SYNC_CASES)
def test_world1_sync_matches_reference(kind, mask, selector):
    """GradientSync.__call__ for the baselines at a world of 1 against the
    reference's per-step path on a 1-device mesh, 3 steps: g_agg, the
    state and the stats bitwise (the genie's histogram selector up to the
    sign of zero, as in round()); under participation (1, 0, 1) the
    sitting-out step gives g_agg = 0 and n_active 0."""
    jcfg, tcfg = _cfgs(kind=kind, selector=selector, sparsity=0.01)
    jst = jsp.init_state(jcfg, J)
    tst = state_from_jax(jax.device_get(jst))
    mesh, fn = _jax_sync(jcfg, jst, mask is not None)
    sync = aggregate.GradientSync(tcfg)
    assert sync.comm == jagg.effective_comm_mode(jcfg) == "simulate"
    rng = np.random.default_rng(len(kind) + (mask is None))
    for t in range(STEPS):
        g = _gauss(rng, J)
        p = True if mask is None else mask[t]
        with mesh:
            jg, jst, jstats = fn(jnp.asarray(g), jst, jnp.asarray(p))
        tg, tst, tstats = sync(
            tst, torch.from_numpy(g),
            participate=None if mask is None else torch.tensor(p),
            with_stats=True)
        assert _same(jg, tg, selector == "exact"), t
        _same_state(jax.device_get(jst), tst, t)
        for key in ("n_active", "dropped_nonfinite"):
            assert float(jstats[key]) == float(tstats[key]), (t, key)
        if not p:
            assert not bool(tg.any())


@pytest.mark.parametrize("kind", ["topk", "regtopk"])
def test_dense_comm_runs_the_simulate_combine(kind):
    """comm_mode="dense" on a local selection runs the simulate combine,
    as the reference's does: g_agg and the state bitwise equal to
    comm_mode="simulate" and to the reference's dense per-step path."""
    jcfg, dense = _cfgs(kind=kind, comm_mode="dense", sparsity=0.01)
    _, simulate = _cfgs(kind=kind, sparsity=0.01)
    assert dispatch.effective_comm_mode(dense) == "dense"
    syncs = [aggregate.GradientSync(dense), aggregate.GradientSync(simulate)]
    states = [sparsify.init_state(c, J, "cpu") for c in (dense, simulate)]
    jst = jsp.init_state(jcfg, J)
    mesh, fn = _jax_sync(jcfg, jst, False)
    rng = np.random.default_rng(3)
    for t in range(STEPS):
        g = _gauss(rng, J)
        with mesh:
            jg, jst, _ = fn(jnp.asarray(g), jst, jnp.asarray(True))
        outs = [sync(st, torch.from_numpy(g))
                for sync, st in zip(syncs, states)]
        states = [st for _, st in outs]
        assert _same(outs[1][0], outs[0][0]), t
        assert _same(jg, outs[0][0]), t
        _same_state(state_to_jax(states[1]), states[0], t)
        _same_state(jax.device_get(jst), states[0], t)


def test_dense_allreduce_leaves_the_gradient():
    g = torch.arange(6.0)
    assert aggregate.dense_allreduce(g) is g       # one rank: no copy


def test_sync_gradient_shim_matches_and_warns_once(monkeypatch):
    """The deprecated shim equals GradientSync(cfg)(...) bit for bit and
    warns DeprecationWarning once per process, in the reference's
    words."""
    monkeypatch.setattr(aggregate, "_shim_warned", False)
    rng = np.random.default_rng(4)
    for kind in ("regtopk", "globaltopk", "none"):
        _, cfg = _cfgs(kind=kind, sparsity=0.01)
        st_a = st_b = sparsify.init_state(cfg, J, "cpu")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for t in range(2):
                g = torch.from_numpy(_gauss(rng, J))
                ga, st_a = aggregate.sync_gradient(cfg, st_a, g)
                gb, st_b = aggregate.GradientSync(cfg)(st_b, g)
                assert _same(gb, ga), (kind, t)
                _same_state(state_to_jax(st_b), st_a, (kind, t))
        msgs = [str(w.message) for w in caught
                if issubclass(w.category, DeprecationWarning)]
        assert len(msgs) == (1 if kind == "regtopk" else 0), msgs
        if msgs:
            assert "sync_gradient is deprecated" in msgs[0]


# ---------------------------------------------------------------------------
# the wire-byte models
# ---------------------------------------------------------------------------

def _cost_grid():
    for kind in ("topk", "dgc", "regtopk", "sketchtopk", "none",
                 "globaltopk"):
        for pipeline in ("reference", "fused"):
            for comm in ("sparse", "simulate", "dense"):
                for selector in ("exact", "histogram"):
                    for fmt in (("dense", "sparse") if kind == "regtopk"
                                else ("dense",)):
                        yield dict(kind=kind, pipeline=pipeline,
                                   comm_mode=comm, selector=selector,
                                   state_format=fmt, sparsity=0.01)


def test_wire_byte_models_match_reference():
    """comm_bytes_per_step, sparse_gather_wire_bytes and
    sketch_allreduce_bytes return what the reference's return, dict for
    dict, over every served config of the grid, N and n_active; a config
    the port does not serve (the fused histogram selector) raises,
    naming its item."""
    served = refused = 0
    warnings.simplefilter("ignore", RuntimeWarning)   # the sketch width cap
    for fields in _cost_grid():
        jcfg, tcfg = (jbase.SparsifierConfig(**fields),
                      tbase.SparsifierConfig(**fields))
        try:
            aggregate.check_supported(tcfg)
        except NotImplementedError as e:
            assert "ROADMAP A8" in str(e), fields
            for fn in (aggregate.comm_bytes_per_step,
                       aggregate.sparse_gather_wire_bytes,
                       aggregate.sketch_allreduce_bytes):
                with pytest.raises(NotImplementedError, match="ROADMAP A8"):
                    fn(tcfg, 1000, 8)
            refused += 1
            continue
        served += 1
        for j in (100, 77_370, 892_032_000):
            for n in (2, 8, 20):
                assert aggregate.sketch_allreduce_bytes(tcfg, j, n) == \
                    jagg.sketch_allreduce_bytes(jcfg, j, n), fields
                for na in (None, 1, 3.5, 100):
                    assert aggregate.comm_bytes_per_step(tcfg, j, n, na) == \
                        jagg.comm_bytes_per_step(jcfg, j, n, na), fields
                    assert aggregate.sparse_gather_wire_bytes(
                        tcfg, j, n, na) == jagg.sparse_gather_wire_bytes(
                        jcfg, j, n, na), fields
        from repro.kernels.compress.dispatch import packed_len
        assert dispatch.packed_len(tcfg, 1000) == packed_len(jcfg, 1000)
        assert dispatch.effective_comm_mode(tcfg) == \
            jagg.effective_comm_mode(jcfg), fields
    assert served >= 60 and refused >= 6, (served, refused)


@pytest.mark.parametrize("field,value,item", [
    ("wire_dtype", "bfloat16", "A8"), ("num_buckets", 4, "A8"),
    ("allocation", "adaptive", "A9")])
def test_wire_byte_models_refuse_configs_outside_the_port(field, value,
                                                          item):
    _, cfg = _cfgs(comm_mode="sparse", pipeline="fused")
    bad = dataclasses.replace(cfg, **{field: value})
    for fn in (aggregate.comm_bytes_per_step,
               aggregate.sparse_gather_wire_bytes,
               aggregate.sketch_allreduce_bytes):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            fn(bad, 1000, 8)
    if field != "wire_dtype":            # the packed length is k either way
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            dispatch.packed_len(bad, 1000)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-5             # as tests/test_torch_train.py
PARAM_ATOL = 1e-5


@pytest.mark.parametrize("flags", [["--sparsifier", "none"],
                                   ["--sparsifier", "globaltopk"],
                                   ["--comm", "dense"]])
def test_launcher_baselines_match_the_reference_train_step(flags):
    """--sparsifier none, --sparsifier globaltopk and --comm dense
    (REGTOP-k) through the port's launcher config and train step against
    the reference launcher's config and train step on a 1x1 mesh, 3
    steps from the same weights on one fixed batch: the losses within
    tests/test_torch_train.py's tolerance, and the parameters within its
    tolerance too, where a selection picks what moves. Dense SGD moves
    every coordinate under Adam, whose first steps move each by about
    lr * sign(g): a coordinate whose gradient is at the level of fp32
    rounding may step the other way in the other package. So for kind
    none at most 1e-4 of the parameters may differ by more than
    PARAM_ATOL, and none by more than 3 steps of 2 * lr."""
    from repro.core.flatten import TreeFlattener as JaxFlattener
    from repro.launch.mesh import make_mesh
    from repro.launch.train import parse_args as jparse
    from repro.train.step import build_parallel
    from repro.train.step import build_train_step as jbuild
    from repro.train.step import init_train_state as jinit
    from repro_torch.convert import params_from_jax
    from repro_torch.core.flatten import TreeFlattener
    from repro_torch.launch.train import parse_args, run_config
    from repro_torch.train.step import build_train_step, init_train_state
    argv = ["--arch", "stablelm-3b", "--smoke", "--steps", "3"] + flags
    trun = run_config(parse_args(argv + ["--device", "cpu"]))
    ja = jparse(argv)
    sp = trun.sparsifier
    assert (sp.kind, sp.comm_mode) == (ja.sparsifier, ja.comm)
    jrun = jbase.RunConfig(
        model=jbase.reduced_config(jbase.get_config("stablelm-3b")),
        shape=jbase.SHAPES["train_4k"],
        sparsifier=jbase.SparsifierConfig(
            kind=sp.kind, sparsity=sp.sparsity, mu=sp.mu,
            comm_mode=sp.comm_mode, pipeline=sp.pipeline,
            selector=sp.selector),
        optimizer=jbase.OptimizerConfig(kind=ja.optimizer, lr=ja.lr),
        seed=0, steps=3)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 32)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((4, 1), np.int32)], 1)
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    with mesh:
        params, opt, ef = jinit(jrun, mesh, pal, jax.random.PRNGKey(0))
        step_fn, _, _ = jbuild(jrun, mesh, pal)
        jstep = jax.jit(step_fn)
        tstate = init_train_state(trun, "cpu", params=params_from_jax(
            jax.device_get(params)))
        assert set(tstate.ef) == set(ef)
        tstep = build_train_step(trun, "cpu")
        jbatch = {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)}
        tbatch = {"tokens": torch.from_numpy(tokens).long(),
                  "targets": torch.from_numpy(targets).long()}
        for t in range(3):
            params, opt, ef, metrics = jstep(params, opt, ef, jbatch,
                                             jax.random.PRNGKey(0))
            tstate, tmetrics = tstep(tstate, tbatch)
            np.testing.assert_allclose(float(tmetrics["loss"]),
                                       float(metrics["loss"]),
                                       rtol=LOSS_RTOL)
        jflat = np.asarray(JaxFlattener(params).flatten(params))
    tflat = TreeFlattener(tstate.params).flatten(tstate.params)
    diff = np.abs(tflat.detach().numpy() - jflat)
    if sp.kind == "none":
        assert (diff > PARAM_ATOL).mean() <= 1e-4, (diff > PARAM_ATOL).sum()
        assert diff.max() <= 3 * 2 * ja.lr
    else:
        assert diff.max() <= PARAM_ATOL, diff.max()
