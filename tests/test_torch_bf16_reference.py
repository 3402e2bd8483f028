"""bf16 error feedback on the reference pipeline (ROADMAP A8's
remainder) against the jitted reference, on the CPU: REGTOP-k with the
dense and the O(k) posterior, the histogram selectors on bf16 scores for
topk, dgc and regtopk, B5's bf16 read, the dense-wire baselines
(kinds none and globaltopk) through ``round``, ``make_round_fn`` and a
gloo world of 2, and three train steps of the sketch on the reference
pipeline with a bf16 state under a fault schedule.

The reference computes these in bf16 jnp operations, and its compiled
CPU program rounds the fp32 result of each to bf16, with its Python
constants rounded to bf16 first, except where the program widens the
result to fp32, which absorbs the rounding (ROADMAP Queue C). Bitwise
throughout, but the histogram selectors' ``mask * a``, a select in the
compiled reference (+0.0 where an unselected entry is negative; the
port's apply kernel multiplies, -0.0), which compares up to the sign of
zero.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import aggregate as jagg  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.core.numerics import safe_denom as jsafe  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import state_to_jax  # noqa: E402
from repro_torch.core import aggregate, sparsify  # noqa: E402
from repro_torch.kernels.fused_ef import kernel as fef  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
J = 3 * 1024 + 37
SPARSITY, MU, DECAY, N = 0.02, 0.5, 0.9, 3
MASK = (True, False, True)   # participation over the 3 compress steps


def _bits(x, zero_sign=True):
    """Bit patterns of an array or tensor (bf16 as uint16); up to the sign
    of zero when ``zero_sign`` is False."""
    if isinstance(x, torch.Tensor):
        if not zero_sign and x.is_floating_point():
            x = x + 0.0
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if not zero_sign and (x.dtype.kind == "f" or x.dtype.name == "bfloat16"):
        x = x + x.dtype.type(0)
    if x.dtype.name == "bfloat16":
        x = x.view(np.uint16)
    if not zero_sign and x.dtype == np.uint16:        # saved bf16 bits
        x = np.where(x == 0x8000, 0, x).astype(np.uint16)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _same(want, got, zero_sign=True):
    return np.array_equal(_bits(want, zero_sign), _bits(got, zero_sign))


def _cfgs(**kw):
    kw = dict(dict(sparsity=SPARSITY, mu=MU, err_decay=DECAY,
                   pipeline="reference", comm_mode="simulate",
                   ef_dtype="bfloat16"), **kw)
    return jbase.SparsifierConfig(**kw), tbase.SparsifierConfig(**kw)


def _gauss(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# compress + observe_aggregate
# ---------------------------------------------------------------------------

COMPRESS_CASES = [
    dict(kind="regtopk"),
    dict(kind="regtopk", selector="histogram"),
    dict(kind="regtopk", selector="histogram_kernel"),
    dict(kind="regtopk", mu=0.1, Q=0.3),
    dict(kind="regtopk", state_format="sparse"),
    dict(kind="regtopk", state_format="sparse", selector="histogram",
         mu=0.1, Q=0.3),
    dict(kind="topk", selector="histogram"),
    dict(kind="topk", selector="histogram_kernel"),
    dict(kind="dgc", selector="histogram"),
    dict(kind="dgc", selector="histogram_kernel"),
]


@pytest.mark.parametrize("case", range(len(COMPRESS_CASES)))
def test_compress_matches_reference(case):
    """Three steps of compress + observe_aggregate under a bf16 state,
    participation (1, 0, 1), err_decay 0.9 and omega 1/3, against the
    jitted reference: packed pairs (where the selection packs them),
    count, dense ghat and mask, every state vector bitwise (the
    histogram selectors' ghat up to the sign of zero). The second step
    sits out: its payload is inert, its error decays and REGTOP-k's
    posterior stays as it was."""
    fields = COMPRESS_CASES[case]
    jcfg, tcfg = _cfgs(**fields)
    omega = 1 / 3
    hist = tcfg.selector != "exact" and tcfg.state_format != "sparse"

    @jax.jit
    def jstep(st, g, g_agg, p):
        o = jsp.compress(jcfg, st, g, omega=omega, participate=p)
        return (o.values, o.indices, o.count, jsp.dense_ghat(o, J),
                jsp.dense_mask(o, J, jnp.bfloat16),
                jsp.observe_aggregate(jcfg, o.state, g_agg, participate=p))

    rng = np.random.default_rng(case)
    jst = jsp.init_state(jcfg, J)
    tst = sparsify.init_state(tcfg, J, "cpu")
    # the port keeps uint32 indices as int32 views of the same bits
    assert {k: str(v.dtype).replace("uint32", "int32")
            for k, v in jst.items()} == {
        k: str(v.dtype).replace("torch.", "") for k, v in tst.items()}
    for t, p in enumerate(MASK):
        g = _gauss(rng, J)
        g_agg = _gauss(rng, J, scale=0.5)
        vals, idx, cnt, ghat, mask, jst = jstep(
            jst, jnp.asarray(g), jnp.asarray(g_agg), jnp.asarray(p))
        out = sparsify.compress(tcfg, tst, torch.from_numpy(g), omega=omega,
                                participate=torch.tensor(p))
        new = sparsify.observe_aggregate(tcfg, out.state,
                                         torch.from_numpy(g_agg),
                                         participate=torch.tensor(p))
        if vals is not None:
            assert _same(vals, out.values), t
            assert _same(idx, out.indices.numpy().view(np.uint32)), t
        assert int(cnt) == int(out.count), t
        assert _same(ghat, sparsify.dense_ghat(out, J), not hist), t
        assert _same(mask, sparsify.dense_mask(out, J).to(torch.bfloat16)), t
        got = state_to_jax(new)
        for key, val in jax.device_get(jst).items():
            assert _same(val, got[key]), (t, key)
        if not p:
            assert not sparsify.dense_ghat(out, J).any()
        tst = new


# ---------------------------------------------------------------------------
# B5's bf16 read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mu,q,omega", [(0.5, 0.0, 1.0), (0.1, 0.3, 1 / 3)])
def test_scores_bf16_matches_compiled_reference(mu, q, omega):
    """B5's bf16 read (plain version) against the reference's dense
    REGTOP-k score chain (src/repro/core/sparsify.py, the dense branch of
    compress) in bf16, jitted: a and the score bitwise, on Gaussian
    inputs with exact zeros of a, tiny a (whose safe divisor is the
    bf16-rounded 1e-12 path) and s_prev of 0 and 1."""
    rng = np.random.default_rng(int(mu * 10))
    g = _gauss(rng, J)
    err = _gauss(rng, J, scale=0.1)
    a_prev, g_agg = _gauss(rng, J), _gauss(rng, J, scale=0.5)
    s_prev = (rng.random(J) < 0.3).astype(np.float32)
    bf = jnp.bfloat16
    gb = np.asarray(jnp.asarray(g).astype(bf).astype(jnp.float32))
    err[::53] = -gb[::53]                    # a == 0 exactly
    g[::71], err[::71] = 1e-30, 0.0          # a tiny: |omega * a| <= 1e-12

    @jax.jit
    def ref(g, err, a_prev, g_agg, s_prev):
        a = err + g.astype(bf)
        safe = jsafe(omega * a)
        delta_sent = (g_agg - omega * a_prev) / safe
        delta = s_prev * delta_sent + q * (1.0 - s_prev)
        reg = jnp.tanh(jnp.abs(1.0 + delta) / mu)
        return a, a * reg

    jins = [jnp.asarray(g)] + [jnp.asarray(x).astype(bf)
                               for x in (err, a_prev, g_agg, s_prev)]
    a_want, s_want = ref(*jins)
    tins = [torch.from_numpy(g)] + [
        torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16) for x in jins[1:]]
    a, score = fef.scores_bf16(*tins, omega=omega, mu=mu, Q=q)
    assert a.dtype == torch.bfloat16 and score.dtype == torch.float32
    assert _same(a_want, a)
    assert torch.equal(score, score.to(torch.bfloat16).float())
    assert _same(s_want, score.to(torch.bfloat16))
    assert int((a == 0).sum()) >= J // 53


# ---------------------------------------------------------------------------
# the dense-wire baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["none", "globaltopk"])
def test_baselines_round_match_reference(kind):
    """Kinds none and globaltopk under a bf16 ef_dtype through round()
    (three rounds: no mask, equal weights 1/3; a mask with one worker
    out; all out) and make_round_fn, against the jitted reference: g_agg
    bitwise (dense SGD all-reduces in bf16, the genie in fp32) and the
    state."""
    jcfg, tcfg = _cfgs(kind=kind)
    jsync, tsync = jagg.GradientSync(jcfg, None), aggregate.GradientSync(tcfg)
    rng = np.random.default_rng(5)
    jst = [jsp.init_state(jcfg, J) for _ in range(N)]
    tst = [sparsify.init_state(tcfg, J, "cpu") for _ in range(N)]
    jround = jax.jit(lambda s, g, p: jsync.round(s, g, participate=p))
    jplain = jax.jit(lambda s, g: jsync.round(s, g))
    for t, mask in enumerate((None, (True, False, True), (False,) * N)):
        g = _gauss(rng, N, J)
        if mask is None:
            ja, jst = jplain(jst, list(jnp.asarray(g)))
        else:
            ja, jst = jround(jst, list(jnp.asarray(g)),
                             [jnp.asarray(p) for p in mask])
        ta, tst = tsync.round(tst, list(torch.from_numpy(g)),
                              participate=None if mask is None
                              else list(mask))
        assert _same(ja, ta), (kind, t)
        for js, ts in zip(jst, tst):
            assert int(js["step"]) == int(ts["step"])
    jfn, tfn = jsp.make_round_fn(jcfg, N), sparsify.make_round_fn(tcfg, N)
    g = _gauss(rng, N, J)
    ja, _ = jfn(jsp.stack_states([jsp.init_state(jcfg, J)] * N),
                jnp.asarray(g))
    ta, _ = tfn(sparsify.stack_states([sparsify.init_state(tcfg, J, "cpu")
                                       for _ in range(N)]),
                torch.from_numpy(g))
    assert _same(ja, ta), kind


GLOO_T, GLOO_J = 3, 2 * 4096 + 517
GLOO_CASES = {
    "none": (dict(kind="none", ef_dtype="bfloat16"), False),
    "none_elastic": (dict(kind="none", ef_dtype="bfloat16"), True),
    "genie_elastic": (dict(kind="globaltopk", ef_dtype="bfloat16"), True),
    "regtopk_dense": (dict(kind="regtopk", ef_dtype="bfloat16",
                           comm_mode="simulate"), True),
}


def test_gloo_world2_matches_reference_mesh(tmp_path):
    """The per-step sync over a gloo world of 2 (one process a rank, each
    with its participation bit) against the reference's GradientSync on a
    mesh of 2 host CPU devices (tests/jax_mesh_worker.py): dense SGD's
    bf16 all-reduce, the genie, and REGTOP-k's dense posterior in bf16
    with the simulate combine. Bitwise in g_agg, n_active and the
    state: a bf16 sum of two values rounds once in any order, so a world
    of 2 is exact for gloo and XLA alike (at 3 or more ranks the
    all-reduce matches only up to its order of additions, each rounded
    to bf16: within (n - 1) bf16 ulps of the sum's magnitude). The
    simulate combine compares g_agg and its posterior copy up to the
    sign of zero (gloo keeps a -0.0 sum)."""
    world = 2
    rng = np.random.default_rng(44)
    grads = (rng.integers(-1024, 1025, (GLOO_T, world, GLOO_J))
             * 2.0 ** -8).astype(np.float32)
    parts = np.array([[True, True], [True, False], [False, False]])
    inp = tmp_path / "inputs.npz"
    np.savez(inp, sparsity=SPARSITY, mu=MU, grads=grads, parts=parts,
             cases=json.dumps(GLOO_CASES))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    out = [tmp_path / f"rank{r}.npz" for r in range(world)]
    ref = tmp_path / "reference.npz"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"),
         "baselines", str(r), str(world), str(tmp_path / "rendezvous"),
         str(inp), str(out[r])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    procs.append(subprocess.Popen(
        [sys.executable, os.path.join(HERE, "jax_mesh_worker.py"),
         str(world), str(inp), str(ref)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks, want = [dict(np.load(f)) for f in out], dict(np.load(ref))
    for name, (_, elastic) in GLOO_CASES.items():
        signed = name != "regtopk_dense"
        for t in range(GLOO_T):
            for r, res in enumerate(ranks):
                got = res[f"{name}_g_agg_{t}"]
                w = want[f"{name}_g_agg_{t}"][r]
                assert got.dtype == w.dtype, (name, got.dtype, w.dtype)
                assert _same(w, got, signed), (name, t, r)
                na = float(res[f"{name}_n_active_{t}"])
                assert na == float(want[f"{name}_n_active_{t}"][r])
                assert na == (parts[t].sum() if elastic else world)
        for r, res in enumerate(ranks):
            assert not bool(res["jax_imported"])
            for key in [k for k in res if k.startswith(f"{name}_state_")]:
                exact = signed or not key.endswith("g_agg_prev")
                assert _same(want[key][r], res[key], exact), (name, r, key)


def test_sketch_train_step_with_a_bf16_state_matches_reference():
    """Three launcher steps of sketchtopk on the reference pipeline with a
    bf16 state under the bursty fault schedule against the reference's
    train step (tests/test_torch_sketch_elastic.py's
    ``train_under_a_schedule``: losses within rtol 1e-5)."""
    sys.path.insert(0, HERE)
    from test_torch_sketch_elastic import train_under_a_schedule
    train_under_a_schedule(dict(pipeline="reference", comm_mode="simulate",
                                ef_dtype="bfloat16"))
