"""The port's reference pipeline against the JAX reference, bitwise:
``compress`` + ``observe_aggregate`` for topk, DGC and REGTOP-k (dense and
O(k) posterior) with the exact, histogram and histogram_kernel
selectors; the port's reference pipeline against its fused one;
``GradientSync`` at a world of 1 (simulate, sparse, and the sparse ->
simulate degrade) against the reference's per-step path under
``shard_map``; ``round()`` against ``GradientSync.round``; the sketch
path's simulate branch; gloo worlds of 2 and 4 in simulate mode; the
state conversion of both reference layouts.

The reference is compiled with ``jax.jit``, as its train step runs it:
the compiled program divides by mu as a multiply by f32(1/mu), contracts
no multiply-add outside tanh, and drops the leading ``0 +`` of a Python
``sum`` (which keeps the sign of -0.0). With a histogram selector its
mask is ``(|score| >= tau).astype(f32)``, and XLA rewrites ``mask * a``
into ``select(|score| >= tau, a, 0)``: unselected entries of its ghat
(and so of g_agg) are +0.0 where the port's apply kernel, like the
reference's own Pallas kernel, computes mask * a = -0.0 (a < 0). Those
vectors are compared up to the sign of zero, every other one bitwise. On
the CPU the kernel wrappers run their plain versions (held against the
CUDA kernels on the card by ``chip_smoke.py``)."""
import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import SparsifierConfig as JaxSparsifierConfig  # noqa: E402
from repro.core import aggregate as jagg  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro_torch.configs.base import SparsifierConfig  # noqa: E402
from repro_torch.convert import state_from_jax, state_to_jax  # noqa: E402
from repro_torch.core import aggregate, sparsify  # noqa: E402
from repro_torch.kernels.compress import dispatch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
J = 3 * 4096 + 517
SPARSITY = 0.01          # k = 128
T = 4


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _same(want, got, zero_sign=True):
    """Bitwise; up to the sign of zero when ``zero_sign`` is False."""
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want = np.asarray(want)
    if not zero_sign:
        want, got = want + np.float32(0.0), got + np.float32(0.0)
    return np.array_equal(_bits(want), _bits(got))


def _zero_sign_kept(cfg) -> bool:
    """False where the compiled reference's ghat has +0.0 for the port's
    -0.0 (the histogram selectors on the dense layouts, see above)."""
    return cfg.selector == "exact" or (cfg.kind == "regtopk"
                                       and cfg.state_format == "sparse")


def _gauss(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _dyadic(rng, *shape):
    return (rng.integers(-1024, 1025, shape) * 2.0 ** -8).astype(np.float32)


def _cfgs(**kw):
    kw = dict(dict(kind="regtopk", sparsity=SPARSITY, mu=0.5,
                   pipeline="reference", comm_mode="simulate"), **kw)
    return JaxSparsifierConfig(**kw), SparsifierConfig(**kw)


def _same_state(jst, tst, ctx, zero_sign=True):
    got = state_to_jax(tst)
    assert set(got) == set(jst), ctx
    for key, val in got.items():
        signed = zero_sign or key != "g_agg_prev"
        assert _same(np.asarray(jst[key]), val, signed), (ctx, key)


LAYOUTS = [("topk", "dense"), ("regtopk", "dense"), ("regtopk", "sparse"),
           ("dgc", "dense")]
SELECTORS = ["exact", "histogram", "histogram_kernel"]


@pytest.mark.parametrize("kind,fmt", LAYOUTS)
@pytest.mark.parametrize("selector", SELECTORS)
def test_compress_matches_reference(kind, fmt, selector):
    """T steps of compress + observe_aggregate (a Gaussian g_agg shared by
    both sides), omega = 1/4: ghat, mask, packed pairs and every state
    vector bitwise. mu = 0.1 and Q = 0.3 exercise the posterior's
    off-support factor and the reciprocal of mu."""
    jcfg, tcfg = _cfgs(kind=kind, state_format=fmt, selector=selector,
                       mu=0.1, Q=0.3)
    omega = 0.25

    @jax.jit
    def jstep(st, g, g_agg):
        out = jsp.compress(jcfg, st, g, omega=omega)
        return (out.ghat, out.mask, out.values, out.indices,
                jsp.observe_aggregate(jcfg, out.state, g_agg))

    rng = np.random.default_rng(SELECTORS.index(selector) * 3
                                + LAYOUTS.index((kind, fmt)))
    jst = jsp.init_state(jcfg, J)
    tst = sparsify.init_state(tcfg, J, "cpu")
    _same_state(jax.device_get(jst), tst, "init")
    signed = _zero_sign_kept(tcfg)
    for t in range(T):
        g, g_agg = _gauss(rng, J), _gauss(rng, J, scale=0.5)
        ghat, mask, vals, idx, jst = jstep(jst, jnp.asarray(g),
                                           jnp.asarray(g_agg))
        out = sparsify.compress(tcfg, tst, torch.from_numpy(g), omega=omega)
        tst = sparsify.observe_aggregate(tcfg, out.state,
                                         torch.from_numpy(g_agg))
        assert _same(ghat, sparsify.dense_ghat(out, J), signed), t
        assert _same(mask, sparsify.dense_mask(out, J)), t
        assert (vals is None) == (out.values is None), t
        if vals is not None:
            assert _same(vals, out.values), t
            assert _same(idx, out.indices), t
        _same_state(jax.device_get(jst), tst, t)
        assert int(sparsify.dense_mask(out, J).sum()) >= \
            sparsify.resolve_k(tcfg, J)



@pytest.mark.parametrize("omega", [1 / 3, 0.1])
def test_sparse_posterior_tie_at_omega_not_dyadic(omega):
    """The O(k) layout (``_compress_regtopk_sparse``) at omega = 1/3 and
    0.1, where omega * a_prev is inexact: the compiled reference rounds
    g_prev - omega * a_prev once (a fused multiply-add). The state is
    built so that every support entry's g_prev - omega * a_prev is the
    same fp32 value d when rounded once, but not always when the product
    is rounded first: the k support keys then tie exactly, and the top-k
    takes the lower half of them by index after the k/2 large off-support
    entries. A posterior rounded twice breaks the tie differently."""
    jcfg, tcfg = _cfgs(state_format="sparse", mu=5.0, Q=0.3)
    k = sparsify.resolve_k(tcfg, J)
    rng = np.random.default_rng(round(1 / omega))
    w = np.float32(omega)
    d = np.float32(1.5) * w                # delta = d / (omega * 1) ~ 1.5
    if not d.view(np.int32) & 1:
        # odd, so that a rounding tie of the two-step form leaves d
        d = np.nextafter(d, np.float32(1.0))
    idx = np.sort(rng.choice(J, k + k // 2, replace=False))
    support, big = idx[:k], idx[k:]
    g = _gauss(rng, J, scale=1e-3)
    g[support], g[big] = 1.0, 100.0
    a_prev = rng.uniform(0.1, 0.9, k).astype(np.float32)
    # g_prev = d + w * a_prev rounded to d's grid (one binade): rounded
    # once, g_prev - w * a_prev is d; rounded twice it leaves d where
    # w * a_prev rounds onto a midpoint of that grid
    g_prev = (d.astype(np.float64) + np.float64(w) * a_prev).astype(
        np.float32)
    twice = g_prev - (w * a_prev)           # rounded twice, in fp32
    assert np.all(np.float32(g_prev.astype(np.float64)
                             - np.float64(w) * a_prev) == d)
    assert np.any(twice != d)
    host = dict(jax.device_get(jsp.init_state(jcfg, J)),
                step=np.int32(1), idx_prev=support.astype(np.uint32),
                a_prev_sel=a_prev, g_prev_sel=g_prev)
    vals, inds, new = jax.jit(lambda st, gg: (lambda o: (
        o.values, o.indices, o.state))(jsp.compress(jcfg, st, gg,
                                                    omega=omega)))(
        host, jnp.asarray(g))
    out = sparsify.compress(tcfg, state_from_jax(host), torch.from_numpy(g),
                            omega=omega)
    assert np.array_equal(np.sort(np.asarray(inds)), np.sort(np.concatenate(
        [big, support[:k - k // 2]]))), "the exact tie-break"
    assert _same(inds, out.indices) and _same(vals, out.values)
    _same_state(jax.device_get(new), out.state, "step 1")

def test_reference_and_fused_pipelines_agree():
    """REGTOP-k, exact selector: the port's reference pipeline (dense
    posterior, kernels B5/B6) and its fused pipeline (sweeps B1/B2)
    select the same indices, and the reference's err equals the fused
    err_prev bitwise, step after step."""
    _, ref = _cfgs(mu=0.5)
    fused = dataclasses.replace(ref, pipeline="fused")
    rng = np.random.default_rng(1)
    sr = sparsify.init_state(ref, J, "cpu")
    sf = sparsify.init_state(fused, J, "cpu")
    for t in range(T):
        g = torch.from_numpy(_gauss(rng, J))
        orf, ofu = (sparsify.compress(ref, sr, g),
                    sparsify.compress(fused, sf, g))
        assert _same(orf.indices.numpy(), ofu.indices), t
        assert _same(orf.state["err"].numpy(), ofu.state["err_prev"]), t
        sr = sparsify.observe_aggregate(ref, orf.state,
                                        sparsify.dense_ghat(orf, J))
        sf = sparsify.observe_aggregate(fused, ofu.state,
                                        sparsify.dense_ghat(ofu, J))


def test_dgc_reference_and_fused_pipelines_agree():
    """DGC, exact selector: both pipelines of the port select the same
    indices, and their error states and momenta agree step after step;
    the momenta up to the sign of zero (the reference pipeline masks
    with mom' * (1 - mask), -0.0 where a negative momentum was selected;
    the fused one scatter-zeroes, +0.0), and both are held bitwise
    against their own reference counterparts elsewhere."""
    _, ref = _cfgs(kind="dgc")
    fused = dataclasses.replace(ref, pipeline="fused")
    rng = np.random.default_rng(2)
    sr = sparsify.init_state(ref, J, "cpu")
    sf = sparsify.init_state(fused, J, "cpu")
    neg_zeros = 0
    for t in range(T):
        g = torch.from_numpy(_gauss(rng, J))
        orf, ofu = (sparsify.compress(ref, sr, g),
                    sparsify.compress(fused, sf, g))
        assert _same(orf.indices.numpy(), ofu.indices), t
        assert _same(orf.state["err"].numpy(), ofu.state["err_prev"]), t
        assert _same(orf.state["mom"].numpy(), ofu.state["mom"], False), t
        neg_zeros += int((orf.state["mom"].view(torch.int32)
                          == -2 ** 31).sum())
        sr, sf = orf.state, ofu.state
    assert neg_zeros > 0


def _jax_sync(cfg, st):
    mesh = jax.make_mesh((1,), ("data",))

    def f(g_, st_):
        return jagg.GradientSync(cfg, ("data",))(st_, g_)

    spec = jax.tree_util.tree_map(lambda _: P(), st)
    with mesh:
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("data"), spec),
                                     out_specs=(P("data"), spec),
                                     check_vma=False))


SYNC_CASES = [
    dict(comm_mode="simulate"),
    dict(comm_mode="sparse"),
    dict(comm_mode="sparse", selector="histogram_kernel"),    # degrades
    dict(comm_mode="simulate", state_format="sparse", selector="histogram"),
    dict(comm_mode="sparse", state_format="sparse", selector="histogram"),
    dict(comm_mode="simulate", kind="topk", selector="histogram"),
    dict(comm_mode="simulate", pipeline="fused"),
    dict(comm_mode="simulate", kind="sketchtopk"),
    dict(comm_mode="simulate", kind="sketchtopk", pipeline="fused"),
    dict(comm_mode="simulate", kind="dgc"),
    dict(comm_mode="sparse", kind="dgc", pipeline="fused"),
]


@pytest.mark.parametrize("case", range(len(SYNC_CASES)))
def test_world1_sync_matches_reference(case):
    """The port's GradientSync call at a world of 1 against the
    reference's per-step path on a 1-device mesh, T steps, bitwise; the
    port starts from the reference's state, converted."""
    jcfg, tcfg = _cfgs(**SYNC_CASES[case])
    jst = jsp.init_state(jcfg, J)
    tst = state_from_jax(jax.device_get(jst))
    fn = _jax_sync(jcfg, jst)
    sync = aggregate.GradientSync(tcfg)
    assert sync.comm == jagg.effective_comm_mode(jcfg)
    rng = np.random.default_rng(30 + case)
    signed = _zero_sign_kept(tcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for t in range(T):
            g = _gauss(rng, J)
            with jax.make_mesh((1,), ("data",)):
                jg, jst = fn(jnp.asarray(g), jst)
            tg, tst = sync(tst, torch.from_numpy(g))
            assert _same(jg, tg, signed), t
            _same_state(jax.device_get(jst), tst, t, signed)


def _jax_round(cfg, states, grads):
    return jax.jit(lambda s, g: jagg.GradientSync(cfg, None).round(s, g))(
        states, [jnp.asarray(x) for x in grads])


ROUND_CASES = [dict(), dict(selector="histogram"),
               dict(kind="topk", selector="histogram_kernel"),
               dict(state_format="sparse"), dict(kind="sketchtopk"),
               dict(kind="dgc", selector="histogram_kernel")]


@pytest.mark.parametrize("n,data", [(2, "gauss"), (4, "dyadic")])
@pytest.mark.parametrize("case", range(len(ROUND_CASES)))
def test_round_matches_reference(n, data, case):
    """round() over n in-process workers against the reference's
    GradientSync.round, T steps, bitwise (g_agg's -0.0 entries included:
    both sum the workers' mask * a without a leading zero)."""
    jcfg, tcfg = _cfgs(**ROUND_CASES[case])
    rng = np.random.default_rng(10 * n + case)
    jstates = [jsp.init_state(jcfg, J) for _ in range(n)]
    tstates = [sparsify.init_state(tcfg, J, "cpu") for _ in range(n)]
    sync = aggregate.GradientSync(tcfg)
    signed = _zero_sign_kept(tcfg)
    for t in range(T):
        grads = [_gauss(rng, J) if data == "gauss" else _dyadic(rng, J)
                 for _ in range(n)]
        jg, jstates = _jax_round(jcfg, jstates, grads)
        tg, tstates = sync.round(tstates, [torch.from_numpy(x)
                                           for x in grads])
        assert _same(jg, tg, signed), t
        for js, ts in zip(jstates, tstates):
            _same_state(jax.device_get(js), ts, t, signed)


def test_sparse_degrade_warns_exactly_once():
    """comm_mode="sparse" with a histogram selector on the reference
    pipeline packs no pairs: the sync runs simulate and warns once per
    (kind, selector, pipeline), in the reference's words."""
    _, cfg = _cfgs(comm_mode="sparse", selector="histogram")
    assert not dispatch.packs_pairs(cfg)
    assert dispatch.effective_comm_mode(cfg) == "simulate"
    aggregate._DEGRADE_WARNED.discard(("regtopk", "histogram", "reference"))
    st = sparsify.init_state(cfg, J, "cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            sync = aggregate.GradientSync(cfg)
            for _ in range(2):
                _, st = sync(st, torch.ones(J))
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1, msgs
    assert "degrading to a dense simulate all-reduce" in msgs[0]
    assert "(pipeline='reference' requested)" in msgs[0]
    for kw in (dict(), dict(state_format="sparse", selector="histogram"),
               dict(kind="sketchtopk")):
        _, ok = _cfgs(comm_mode="sparse", **kw)
        assert dispatch.effective_comm_mode(ok) == "sparse", kw


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
def test_reference_states_cross_both_ways(fmt):
    jcfg, tcfg = _cfgs(state_format=fmt)
    rng = np.random.default_rng(5)
    jst = jsp.init_state(jcfg, J)
    for _ in range(2):
        jst = jax.jit(lambda s, g: jsp.compress(jcfg, s, g).state)(
            jst, jnp.asarray(_gauss(rng, J)))
    host = jax.device_get(jst)
    tst = state_from_jax(host)
    if fmt == "sparse":
        assert tst["idx_prev"].dtype == torch.int32
        assert host["idx_prev"].dtype == np.uint32
    else:
        assert {k for k, v in tst.items() if v.numel() == J} == {
            "err", "a_prev", "s_prev", "g_agg_prev"}
    back = state_to_jax(tst)
    for key, val in host.items():
        assert back[key].dtype == np.asarray(val).dtype, key
        assert _same(val, back[key]), key


def _run_world(tmp_path, world, **data):
    inp = tmp_path / "inputs.npz"
    np.savez(inp, sparsity=SPARSITY, mu=0.5, **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"), "sync",
         str(r), str(world), str(tmp_path / "rendezvous"), str(inp),
         str(tmp_path / f"rank{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world,data,kind", [(2, "gauss", "regtopk"),
                                             (4, "dyadic", "regtopk"),
                                             (4, "gauss", "topk")])
def test_gloo_simulate_matches_reference_round(tmp_path, world, data, kind):
    """Simulate comm over gloo (the dense ghat all-reduced: SUM, then
    divided by n) against the reference's round on the reference
    pipeline. World 2 and dyadic inputs are bitwise (a sum of two terms
    does not depend on its order; dyadic sums are exact in any order).
    World 4 on Gaussian inputs adds four vectors in gloo's order, not the
    reference's rank order: g_agg within 2*(n-1)*2^-24 * sum_r |ghat_r| / n
    of the reference's per entry, the states (whose TOP-k selection is
    local) bitwise."""
    rng = np.random.default_rng(40 + world)
    draw = _gauss if data == "gauss" else _dyadic
    grads = np.stack([np.stack([draw(rng, J) for _ in range(world)])
                      for _ in range(T)])
    ranks = _run_world(tmp_path, world, grads=grads, kind=kind,
                       pipeline="reference", comm_mode="simulate")
    jcfg, tcfg = _cfgs(kind=kind)
    states = [jsp.init_state(jcfg, J) for _ in range(world)]
    tstates = [sparsify.init_state(tcfg, J, "cpu") for _ in range(world)]
    sync = aggregate.GradientSync(tcfg)
    exact = world == 2 or data == "dyadic"
    for t in range(T):
        g_agg, states = _jax_round(jcfg, states, list(grads[t]))
        want = np.asarray(g_agg)
        mass = sum(sparsify.dense_ghat(sparsify.compress(
            tcfg, s, torch.from_numpy(g), omega=1.0 / world), J).abs()
            for s, g in zip(tstates, grads[t])).numpy() / world
        _, tstates = sync.round(tstates, [torch.from_numpy(g)
                                          for g in grads[t]])
        for r, res in enumerate(ranks):
            got = res[f"g_agg_{t}"]
            assert np.array_equal(got.view(np.int32),
                                  ranks[0][f"g_agg_{t}"].view(np.int32))
            if exact:
                assert _same(want, got), (t, r)
            else:
                bound = 2 * (world - 1) * 2.0 ** -24 * mass
                assert np.all(np.abs(got - want) <= bound), (t, r)
    for r, res in enumerate(ranks):
        assert not bool(res["jax_imported"])
        for key, val in jax.device_get(states[r]).items():
            got = res[f"state_{key}"]
            assert _same(np.asarray(val), got), (r, key)
