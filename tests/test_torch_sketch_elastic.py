"""The sketch's elastic, bucketed and bf16 paths (ROADMAP A12 with A10)
against the reference, on the CPU.

B3's gated form and bf16 read (plain versions) against the reference's
``masked_inputs`` and ``sweep1_sketch_pallas`` under ``interpret=True``;
``GradientSync.round`` and ``make_round_fn`` against the jitted
reference over three rounds whose masks are all in, one out and all out;
the per-step sync on a one-device mesh (both pipelines, fp32 and bf16
state, 1 and 3 buckets with k = 61, so the last chunk is padded, both
wires, the histogram selector) and over a gloo world of 3 with one rank
sitting out against the reference's mesh of 3; an all-in mask against
``participate=None``; the wire-byte models; three launcher steps of a
reduced StableLM under a fault schedule against the reference's train
step (``train_under_a_schedule``, which tests/test_torch_bf16_reference.py
runs on the reference pipeline with a bf16 state).

Bitwise throughout, with two stated exceptions. The histogram selectors'
``mask * a`` is a select in the compiled reference (an unselected
negative entry is +0.0 there, -0.0 here, where the apply kernel
multiplies), so their g_agg compares up to the sign of zero (ROADMAP
Queue C). The train steps compare as tests/test_torch_train.py does:
the loss within rtol 1e-5.
"""
import dataclasses
import json
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

from repro.configs import base as jbase  # noqa: E402
from repro.core import aggregate as jagg  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.kernels.compress import kernel as jpk  # noqa: E402
from repro.kernels.compress import ops as jops  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import aggregate, sparsify  # noqa: E402
from repro_torch.kernels.compress import kernel as pk  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
J = 3050                     # k = 61 at SPARSITY: 3 chunks of 21, 2 padded
SPARSITY, DECAY, N = 0.02, 0.9, 3
MASKS = ((True, True, True), (True, False, True), (False, False, False))
warnings.simplefilter("ignore", RuntimeWarning)   # the sketch width cap


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
    if x.dtype.name == "bfloat16":
        if not zero_sign:
            x = x + x.dtype.type(0)
        return x.view(np.uint16)
    if not zero_sign and x.dtype.kind == "f":
        x = x + x.dtype.type(0)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _same(want, got, zero_sign=True):
    return np.array_equal(_bits(want, zero_sign), _bits(got, zero_sign))


def _cfgs(**kw):
    kw = dict(dict(kind="sketchtopk", sparsity=SPARSITY, err_decay=DECAY),
              **kw)
    return jbase.SparsifierConfig(**kw), tbase.SparsifierConfig(**kw)


def _gauss(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _dyadic(rng, *shape):
    return (rng.integers(-1024, 1025, shape) * 2.0 ** -8).astype(np.float32)


# ---------------------------------------------------------------------------
# B3's new modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,gate", [("bf16", None), ("gated", 0),
                                       ("gated", 1), ("gated_bf16", 0),
                                       ("gated_bf16", 1)])
def test_sweep1_sketch_modes_match_pallas(mode, gate):
    """B3's plain version in each new mode against the reference's masked
    inputs (in XLA) and its Pallas sweep 1 with the encode folded in
    (interpret mode): a and the sketch bitwise on dyadic inputs, whose
    bucket sums are exact in any order. A bf16 state is widened, g stays
    fp32; a sitting-out worker's a is its decayed error (rounded to the
    state's dtype) plus +0.0, so a -0.0 error gives +0.0."""
    rng = np.random.default_rng(len(mode) + (gate or 0))
    rows, width = 3, 512
    g, err = _dyadic(rng, J), _dyadic(rng, J)
    err[::97] = -0.0
    bf = mode.endswith("bf16")
    jerr = jnp.asarray(err).astype(jnp.bfloat16 if bf else jnp.float32)
    from repro.core import sketch as jsk
    mults = tuple(int(x) for x in jsk._MULTS[:rows])
    adds = tuple(int(x) for x in jsk._ADDS[:rows])

    @jax.jit
    def ref(g, err, p):
        if p is not None:
            g, err, _ = jops.masked_inputs(g, err, p, DECAY)
        return jpk.sweep1_sketch_pallas(g, err, rows=rows, width=width,
                                        mults=mults, adds=adds,
                                        interpret=True)

    a_want, sk_want = ref(jnp.asarray(g), jerr,
                          None if gate is None else jnp.asarray(bool(gate)))
    terr = torch.from_numpy(np.asarray(jerr.astype(jnp.float32))).to(
        torch.bfloat16 if bf else torch.float32)
    tg = torch.from_numpy(g)
    if gate is None:
        a, sk = pk.sweep1_sketch_bf16(tg, terr, rows, width)
    else:
        a, sk = pk.sweep1_sketch_gated(tg, terr, torch.tensor([float(gate)]),
                                       DECAY, rows, width)
    assert _same(a_want, a) and _same(sk_want, sk)
    if gate == 0:
        assert not np.signbit(a.numpy()[::97]).any()
    if gate == 1:                     # gate 1: the ungated bits
        a1, sk1 = pk.sweep1_sketch(tg, terr, rows, width)
        assert torch.equal(a1, a) and torch.equal(sk1, sk)


# ---------------------------------------------------------------------------
# round() and make_round_fn
# ---------------------------------------------------------------------------

ROUND_CASES = [
    dict(pipeline="fused", ef_dtype="float32", selector="exact"),
    dict(pipeline="fused", ef_dtype="bfloat16", selector="histogram",
         combine="support"),
    dict(pipeline="reference", ef_dtype="float32",
         selector="histogram_kernel"),
    dict(pipeline="reference", ef_dtype="bfloat16", selector="exact",
         combine="support"),
    dict(pipeline="reference", ef_dtype="bfloat16", selector="histogram"),
]


@pytest.mark.parametrize("case", range(len(ROUND_CASES)))
def test_round_matches_reference(case):
    """Three rounds of three workers with masks all in, one out and all
    out, against the jitted reference's round: g_agg and every state
    bitwise (the histogram selectors' g_agg up to the sign of zero). A
    sitting-out worker's error is its decayed error; all out gives
    g_agg = 0. Explicit omegas with a mask raise the reference's
    ValueError."""
    fields = ROUND_CASES[case]
    jcfg, tcfg = _cfgs(**fields)
    jsync, tsync = jagg.GradientSync(jcfg, None), aggregate.GradientSync(tcfg)
    zero_sign = fields["selector"] == "exact"
    rng = np.random.default_rng(case)
    jst = [jsp.init_state(jcfg, J) for _ in range(N)]
    tst = [sparsify.init_state(tcfg, J, "cpu") for _ in range(N)]
    assert {k: str(v.dtype) for k, v in jst[0].items()} == {
        k: str(v.dtype).replace("torch.", "") for k, v in tst[0].items()}
    jround = jax.jit(lambda s, g, p: jsync.round(s, g, participate=p))
    for t, mask in enumerate(MASKS):
        g = _gauss(rng, N, J) * (1 + t)
        ja, jst = jround(jst, list(jnp.asarray(g)),
                         [jnp.asarray(p) for p in mask])
        old = [dict(s) for s in tst]
        ta, tst = tsync.round(tst, list(torch.from_numpy(g)),
                              participate=list(mask))
        assert _same(ja, ta, zero_sign), t
        for i, (js, ts) in enumerate(zip(jst, tst)):
            for key in ts:
                assert _same(js[key], ts[key]), (t, i, key)
            if not mask[i]:
                ek = sparsify.err_key(tcfg)
                want = (DECAY * old[i][ek].float()).to(old[i][ek].dtype)
                assert _same(want + 0.0, ts[ek]), (t, i)
        if not any(mask):
            assert not ta.any()
    with pytest.raises(ValueError, match="omegas") as ref:
        jsync.round(jst, list(jnp.asarray(g)), omegas=[0.5, 0.25, 0.25],
                    participate=[True] * N)
    with pytest.raises(ValueError) as got:
        tsync.round(tst, list(torch.from_numpy(g)),
                    omegas=[0.5, 0.25, 0.25], participate=[True] * N)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("fields", [
    dict(pipeline="fused", ef_dtype="bfloat16"),
    dict(pipeline="reference", ef_dtype="bfloat16",
         selector="histogram_kernel")])
def test_make_round_fn_matches_reference(fields):
    """make_round_fn over stacked states, three rounds, against the
    reference's jitted one: g_agg and the stacked states bitwise (the
    histogram selector's g_agg up to the sign of zero)."""
    jcfg, tcfg = _cfgs(**fields)
    jfn, tfn = jsp.make_round_fn(jcfg, N), sparsify.make_round_fn(tcfg, N)
    jst = jsp.stack_states([jsp.init_state(jcfg, J) for _ in range(N)])
    tst = sparsify.stack_states([sparsify.init_state(tcfg, J, "cpu")
                                 for _ in range(N)])
    rng = np.random.default_rng(7)
    zero_sign = tcfg.selector == "exact"
    for t in range(3):
        g = _gauss(rng, N, J)
        ja, jst = jfn(jst, jnp.asarray(g))
        ta, tst = tfn(tst, torch.from_numpy(g))
        assert _same(ja, ta, zero_sign), t
        for key in tst:
            assert _same(jst[key], tst[key]), (t, key)


# ---------------------------------------------------------------------------
# the per-step sync at world 1
# ---------------------------------------------------------------------------

SYNC_CASES = [
    dict(pipeline="fused", comm_mode="sparse"),
    dict(pipeline="fused", comm_mode="sparse", ef_dtype="bfloat16",
         num_buckets=3, wire_dtype="bfloat16"),
    dict(pipeline="fused", comm_mode="simulate", ef_dtype="bfloat16",
         selector="histogram"),
    dict(pipeline="reference", comm_mode="sparse", ef_dtype="bfloat16",
         num_buckets=3),
    dict(pipeline="reference", comm_mode="sparse", wire_dtype="bfloat16"),
    dict(pipeline="reference", comm_mode="simulate", ef_dtype="bfloat16",
         selector="histogram_kernel"),
]
SYNC_MASK = (True, False, True)


def _jax_sync(jcfg, jst, elastic: bool):
    mesh = jax.make_mesh((1,), ("data",))
    tmap = jax.tree_util.tree_map

    def f(g, st, p):
        st = tmap(lambda x: x[0], st)
        g_agg, new, stats = jagg.GradientSync(jcfg, ("data",))(
            st, g[0], participate=p[0] if elastic else None,
            with_stats=True)
        return g_agg[None], tmap(lambda x: x[None], new), \
            stats["n_active"][None]

    spec = tmap(lambda _: P("data"), jst)
    return mesh, jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("data"), spec, P("data")),
        out_specs=(P("data"), spec, P("data")), check_vma=False))


@pytest.mark.parametrize("case", range(len(SYNC_CASES)))
def test_world1_sync_matches_reference(case):
    """The per-step sync on a one-device mesh, three steps with the
    participation bits (1, 0, 1), against the reference's GradientSync
    under shard_map: g_agg, n_active and the state bitwise (the
    histogram selectors' g_agg up to the sign of zero). The same steps
    with an all-in mask give the bits of participate=None."""
    jcfg, tcfg = _cfgs(**SYNC_CASES[case])
    zero_sign = tcfg.selector == "exact"
    jst = jax.tree_util.tree_map(lambda x: x[None],
                                 jsp.init_state(jcfg, J))
    mesh, fn = _jax_sync(jcfg, jst, True)
    sync, plain = aggregate.GradientSync(tcfg), aggregate.GradientSync(tcfg)
    tst = sparsify.init_state(tcfg, J, "cpu")
    pst = all_in = tst
    rng = np.random.default_rng(20 + case)
    for t, p in enumerate(SYNC_MASK):
        g = _gauss(rng, J)
        with mesh:
            ja, jst, jna = fn(jnp.asarray(g)[None], jst, jnp.asarray([p]))
        tg = torch.from_numpy(g)
        ta, tst, stats = sync(tst, tg, participate=torch.tensor(p),
                              with_stats=True)
        assert _same(ja[0], ta, zero_sign), t
        assert float(jna[0]) == float(stats["n_active"]) == float(p)
        for key in tst:
            assert _same(jst[key][0], tst[key]), (t, key)
        # an all-in mask against no mask, on the same stream
        pa, pst = plain(pst, tg)
        aa, all_in = sync(all_in, tg, participate=torch.tensor(True))
        assert _same(pa, aa) and all(_same(pst[k], all_in[k]) for k in pst)


# ---------------------------------------------------------------------------
# gloo world 3 against the reference's mesh of 3
# ---------------------------------------------------------------------------

GLOO_T, GLOO_J, GLOO_MU = 3, 2 * 4096 + 517, 0.5
GLOO_CASES = {
    "fused": (dict(kind="sketchtopk", pipeline="fused", comm_mode="sparse",
                   err_decay=DECAY), True),
    "fused_chunked_bf16": (dict(kind="sketchtopk", pipeline="fused",
                                comm_mode="sparse", err_decay=DECAY,
                                ef_dtype="bfloat16", num_buckets=3,
                                wire_dtype="bfloat16"), True),
    "reference_simulate": (dict(kind="sketchtopk", pipeline="reference",
                                comm_mode="simulate", err_decay=DECAY,
                                combine="support"), True),
}


def test_gloo_world3_matches_reference_mesh(tmp_path):
    """The per-step sync over a gloo world of 3, each rank its own process
    with its own participation bit (all in, then rank 1 out, then rank
    0 out), against the reference's GradientSync on a mesh of 3 host CPU
    devices (tests/jax_mesh_worker.py): g_agg on every rank, n_active and
    every rank's final state bitwise. The gradients are dyadic (k *
    2^-8, |k| <= 2^10), so every bucket and every sum across ranks is
    exact in any order. The simulate combine compares g_agg up to the
    sign of zero (gloo keeps a -0.0 sum, ROADMAP Queue C)."""
    world = 3
    rng = np.random.default_rng(33)
    grads = _dyadic(rng, GLOO_T, world, GLOO_J)
    parts = np.array([[True] * world, [True, False, True],
                      [False, True, True]])
    inp = tmp_path / "inputs.npz"
    np.savez(inp, sparsity=SPARSITY, mu=GLOO_MU, grads=grads, parts=parts,
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
        signed = name != "reference_simulate"
        for t in range(GLOO_T):
            for r, res in enumerate(ranks):
                assert _same(want[f"{name}_g_agg_{t}"][r],
                             res[f"{name}_g_agg_{t}"], signed), (name, t, r)
                assert _same(ranks[0][f"{name}_g_agg_{t}"],
                             res[f"{name}_g_agg_{t}"]), (name, t, r)
                na = float(res[f"{name}_n_active_{t}"])
                assert na == float(want[f"{name}_n_active_{t}"][r])
                assert na == (parts[t].sum() if elastic else world)
        for r, res in enumerate(ranks):
            assert not bool(res["jax_imported"])
            keys = [k for k in res if k.startswith(f"{name}_state_")]
            assert sorted(keys) == sorted(k for k in want
                                          if k.startswith(f"{name}_state_"))
            for key in keys:
                assert _same(want[key][r], res[key]), (name, r, key)


# ---------------------------------------------------------------------------
# the wire-byte models and the gates
# ---------------------------------------------------------------------------

def test_wire_byte_models_match_reference():
    """comm_bytes_per_step, sparse_gather_wire_bytes and
    sketch_allreduce_bytes of the sketch with buckets, the bf16 state
    and wire, the histogram selectors and the elastic fields, on both
    pipelines and all three comm modes, equal the reference's."""
    n = 0
    for pipeline in ("fused", "reference"):
        for comm in ("sparse", "simulate", "dense"):
            for extra in (dict(num_buckets=8, wire_dtype="bfloat16"),
                          dict(ef_dtype="bfloat16", selector="histogram"),
                          dict(selector="histogram_kernel",
                               combine="support"),
                          dict(err_decay=0.5, sketch_width=1000)):
                jcfg, tcfg = _cfgs(pipeline=pipeline, comm_mode=comm,
                                   **extra)
                for j in (100, 77_370, 892_032_000):
                    for nw in (2, 8):
                        assert aggregate.sketch_allreduce_bytes(
                            tcfg, j, nw) == jagg.sketch_allreduce_bytes(
                            jcfg, j, nw)
                        for na in (None, 1, 3.5):
                            assert aggregate.comm_bytes_per_step(
                                tcfg, j, nw, na) == \
                                jagg.comm_bytes_per_step(jcfg, j, nw, na)
                            assert aggregate.sparse_gather_wire_bytes(
                                tcfg, j, nw, na) == \
                                jagg.sparse_gather_wire_bytes(jcfg, j, nw,
                                                              na)
                n += 1
    assert n == 24


def test_state_layout_matches_reference():
    """The sketch's state on both pipelines and in both dtypes (the
    fused histogram_kernel config runs the reference pipeline, as the
    reference's dispatch routes it): the reference's keys and dtypes."""
    for pipeline in ("fused", "reference"):
        for ef in ("float32", "bfloat16"):
            for selector in ("exact", "histogram", "histogram_kernel"):
                jcfg, tcfg = _cfgs(pipeline=pipeline, ef_dtype=ef,
                                   selector=selector)
                jst = jsp.init_state(jcfg, 64)
                tst = sparsify.init_state(tcfg, 64, "cpu")
                assert {k: str(v.dtype) for k, v in jst.items()} == {
                    k: str(v.dtype).replace("torch.", "")
                    for k, v in tst.items()}


# ---------------------------------------------------------------------------
# the train step under a fault schedule
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-5             # as tests/test_torch_train.py


def train_under_a_schedule(fields: dict) -> None:
    """Three launcher steps of the reduced StableLM with
    ``--sparsifier sketchtopk --fault-schedule bursty:period=3,outage=1,
    workers=0 --err-decay 0.9`` and ``fields`` over the launcher's
    config (the one rank sits out step 0) against the reference's train
    step: losses within rtol 1e-5 (tests/test_torch_train.py's), the
    error state's keys and dtypes, n_active [0, 1, 1] in both."""
    from repro.launch.mesh import make_mesh
    from repro.train.step import build_parallel
    from repro.train.step import build_train_step as jbuild
    from repro.train.step import init_train_state as jinit
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.train import parse_args, run_config
    from repro_torch.train.step import build_train_step, init_train_state
    spec = "bursty:period=3,outage=1,workers=0"
    argv = ["--arch", "stablelm-3b", "--smoke", "--steps", "3",
            "--sparsifier", "sketchtopk", "--fault-schedule", spec,
            "--err-decay", str(DECAY), "--comm", fields["comm_mode"],
            "--pipeline", fields["pipeline"], "--device", "cpu"]
    trun = run_config(parse_args(argv))
    trun = dataclasses.replace(trun, sparsifier=dataclasses.replace(
        trun.sparsifier, **fields))
    sp = trun.sparsifier
    jrun = jbase.RunConfig(
        model=jbase.reduced_config(jbase.get_config("stablelm-3b")),
        shape=jbase.SHAPES["train_4k"],
        sparsifier=jbase.SparsifierConfig(**dataclasses.asdict(sp)),
        optimizer=jbase.OptimizerConfig(
            **dataclasses.asdict(trun.optimizer)),
        seed=trun.seed, steps=3, fault_schedule=spec)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 32)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((4, 1), np.int32)], 1)
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    with mesh:
        params, opt, ef = jinit(jrun, mesh, pal, jax.random.PRNGKey(0))
        jstep = jax.jit(jbuild(jrun, mesh, pal)[0])
        tstate = init_train_state(trun, "cpu", params=params_from_jax(
            jax.device_get(params)))
        assert {k: str(v.dtype) for k, v in ef.items()} == {
            k: str(v.dtype).replace("torch.", "")
            for k, v in tstate.ef.items()}
        tstep = build_train_step(trun, "cpu")
        jbatch = {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)}
        tbatch = {"tokens": torch.from_numpy(tokens).long(),
                  "targets": torch.from_numpy(targets).long()}
        active = []
        for t in range(3):
            params, opt, ef, m = jstep(params, opt, ef, jbatch,
                                       jax.random.PRNGKey(0))
            tstate, tm = tstep(tstate, tbatch)
            np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                       rtol=LOSS_RTOL)
            assert float(tm["n_active"]) == float(m["n_active"]), t
            active.append(float(tm["n_active"]))
    assert active == [0.0, 1.0, 1.0]


def test_train_step_under_a_fault_schedule_matches_reference():
    """The fused pipeline with sparse comm (B3's gated form); the
    reference pipeline with a bf16 state runs in
    tests/test_torch_bf16_reference.py."""
    train_under_a_schedule(dict(pipeline="fused", comm_mode="sparse"))
