"""The port's fused compressor against the reference's, bitwise.

T = 4 steps of ``compress`` + ``observe_aggregate`` on identical gradient
streams, for topk, dgc (momentum 0.9) and regtopk, against (a) the reference's jitted
``sparsify.compress`` on the fused pipeline and (b) its
``fused_compress_arrays`` with the Pallas kernels in interpret mode, fed
the port's own pre-step state. The reference is compiled with ``jax.jit``
as the train step compiles it: under jit, XLA folds the constant factor c
with the host's tanh and divides by mu as a multiply by 1/mu, and the
port follows that program (core.numerics)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SparsifierConfig as JaxSparsifierConfig  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.kernels.compress import ops as jops  # noqa: E402
from repro_torch.configs.base import SparsifierConfig  # noqa: E402
from repro_torch.convert import state_from_jax, state_to_jax  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.core.numerics import regularizer_factor  # noqa: E402
from repro_torch.core.select import topk_indices  # noqa: E402
from repro_torch.kernels.compress.ops import posterior_keys  # noqa: E402

T = 4
MU = 0.5


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _eq(a, b):
    b = b.numpy() if isinstance(b, torch.Tensor) else b
    return np.array_equal(_bits(a), _bits(b))


def _grads(case, j, rng):
    if case == "tie":
        # every |g| equal: all keys tie at the k-th, tiles overflow and
        # the trim takes the exact fallback with its index tie-break
        return np.where(rng.random(j) < 0.5, -1.0, 1.0).astype(np.float32)
    return rng.standard_normal(j).astype(np.float32)


@pytest.mark.parametrize("kind", ["topk", "dgc", "regtopk"])
@pytest.mark.parametrize("case,j", [("normal", 3 * 4096),
                                    ("ragged", 3 * 4096 + 1000),
                                    ("tie", 3 * 4096)])
def test_compress_matches_reference(kind, case, j):
    kw = dict(kind=kind, sparsity=0.01, mu=MU, pipeline="fused",
              comm_mode="sparse")
    jcfg, tcfg = JaxSparsifierConfig(**kw), SparsifierConfig(**kw)
    k = tsp.resolve_k(tcfg, j)

    def jax_compress(st, g):
        o = jsp.compress(jcfg, st, g)
        return o.values, o.indices, o.state

    jcomp = jax.jit(jax_compress)
    jobs = jax.jit(lambda st, ga: jsp.observe_aggregate(jcfg, st, ga))
    jpallas = jax.jit(lambda g, st: jops.fused_compress_arrays(
        kind, g, st["err_prev"], st["step"], k=k, mu=MU,
        momentum=tcfg.momentum, mom=st.get("mom"),
        idx_prev=st.get("idx_prev"), a_prev_sel=st.get("a_prev_sel"),
        g_prev_sel=st.get("g_prev_sel"), want_ghat=False,
        strategy="pallas_interpret"))
    rng = np.random.default_rng(11)
    jst = jsp.init_state(jcfg, j)
    tst = tsp.init_state(tcfg, j, "cpu")
    fallbacks = []
    for t in range(T):
        g = _grads(case, j, rng)
        g_agg = rng.standard_normal(j).astype(np.float32)
        pst = jax.device_get(state_to_jax(tst))
        jv, ji, jnew = jcomp(jst, jnp.asarray(g))
        pout = jpallas(jnp.asarray(g), pst)
        out = tsp.compress(tcfg, tst, torch.from_numpy(g))
        fallbacks.append(out.fallback)
        assert _eq(jv, out.values) and _eq(ji, out.indices), t
        assert _eq(pout["values"], out.values), t
        assert _eq(pout["indices"], out.indices), t
        assert _eq(pout["err"], out.state["err_prev"]), t
        if kind == "dgc":
            assert _eq(pout["mom"], out.state["mom"]), t
        jst = jobs(jnew, jnp.asarray(g_agg))
        tst = tsp.observe_aggregate(tcfg, out.state,
                                    torch.from_numpy(g_agg))
        got = state_to_jax(tst)
        assert sorted(got) == sorted(jst)
        for key in jst:
            assert _eq(jst[key], got[key]), (t, key)
    assert any(fallbacks) == (case == "tie")


@pytest.mark.parametrize("Q,mu", [(0.0, 0.1), (0.0, 0.5), (0.0, 0.2),
                                  (0.3, 0.7), (-0.5, 0.123)])
def test_score_factor_matches_compiled_reference(Q, mu):
    want = jax.jit(lambda: jnp.tanh(jnp.abs(1.0 + jnp.float32(Q)) / mu))()
    assert np.float32(regularizer_factor(Q, mu)) == np.asarray(want)
    assert _eq(np.asarray(want).reshape(1),
               np.asarray([regularizer_factor(Q, mu)], np.float32))


@pytest.mark.parametrize("mu,omega", [(0.1, 1.0), (0.5, 0.5), (0.3, 0.25),
                                      (0.5, 1 / 3), (0.1, 0.1)])
def test_posterior_keys_match_compiled_reference(mu, omega):
    """At omega = 1/3 and 0.1 the product omega * a_prev is inexact, so
    g_prev - omega * a_prev rounded once (the compiled reference's fused
    multiply-add) differs from a multiply and a subtract rounded apart."""
    rng = np.random.default_rng(5)
    n = 200_000
    a_sel, a_prev, g_prev = (rng.standard_normal(n).astype(np.float32)
                             for _ in range(3))
    a_sel[:100] = 0.0                      # exercise safe_denom
    step = np.int32(3)
    want = jax.jit(lambda a, ap, gp: jops._posterior_keys(
        a, ap, gp, step, omega=omega, mu=mu))(a_sel, a_prev, g_prev)
    got = posterior_keys(*(torch.from_numpy(x) for x in
                           (a_sel, a_prev, g_prev)),
                         torch.tensor(step), omega=omega, mu=mu)
    assert _eq(want, got)


def test_state_conversion_round_trip():
    cfg = JaxSparsifierConfig(kind="regtopk", pipeline="fused",
                              comm_mode="sparse", sparsity=0.01)
    st = jax.device_get(jsp.init_state(cfg, 5000))
    st["idx_prev"] = np.arange(4_294_967_295 - st["idx_prev"].size,
                               4_294_967_295, dtype=np.uint32)
    back = state_to_jax(state_from_jax(st))
    for key in st:
        assert back[key].dtype == st[key].dtype and _eq(st[key], back[key])


@pytest.mark.parametrize("pipeline", ["fused", "reference"])
def test_dgc_and_optimizer_states_round_trip(pipeline):
    """A DGC state after two steps (err or err_prev, mom, step) and the
    optimizer states of every kind cross both ways as fp32, bit for
    bit."""
    from repro.configs.base import OptimizerConfig
    from repro.optim import apply_updates, init_opt_state
    cfg = JaxSparsifierConfig(kind="dgc", pipeline=pipeline,
                              comm_mode="sparse", sparsity=0.01)
    rng = np.random.default_rng(3)
    st = jsp.init_state(cfg, 5000)
    for _ in range(2):
        st = jax.jit(lambda s, g: jsp.compress(cfg, s, g).state)(
            st, jnp.asarray(rng.standard_normal(5000).astype(np.float32)))
    states = [jax.device_get(st)]
    for kind in ("sgd", "momentum", "adam", "adamw"):
        ocfg = OptimizerConfig(kind=kind)
        ost = init_opt_state(ocfg, jnp.ones(300, jnp.float32))
        _, ost = apply_updates(ocfg, ost, jnp.asarray(
            rng.standard_normal(300).astype(np.float32)))
        states.append(jax.device_get(ost))
    assert set(states[0]) == {tsp.err_key(SparsifierConfig(
        pipeline=pipeline)), "mom", "step"}
    assert np.any(states[0]["mom"] != 0)
    for host in states:
        tst = state_from_jax(host)
        for key, val in tst.items():
            want = np.asarray(host[key]).dtype
            assert val.dtype == (torch.float32 if want == np.float32
                                 else torch.int32), key
        back = state_to_jax(tst)
        for key in host:
            assert back[key].dtype == np.asarray(host[key]).dtype, key
            assert _eq(host[key], back[key]), key


@pytest.mark.parametrize("k", [1, 2, 4, 6])
def test_topk_tie_order_matches_lax_top_k(k):
    """(key desc, position asc), where torch.topk orders ties freely."""
    score = np.array([1, -3, 3, 2, -3, 0, 3], np.float32)
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(score)), k)
    got = topk_indices(torch.from_numpy(score), k)
    assert np.array_equal(np.asarray(want), got.numpy())
