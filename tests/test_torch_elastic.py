"""Elastic participation in the port against the reference, bitwise:
sweep 1's gated variant (plain version) against the Pallas kernel's
``gate=`` operand in interpret mode, ``compress(participate=)`` on both
pipelines, ``GradientSync.round(participate=)`` with both combines, gloo
worlds of 3, 4 and 8 under an iid schedule, the non-finite guard, and the
train step and launcher under a fault schedule.

The reference runs under ``jax.jit`` with the participation bit passed as
a traced argument, as its train step passes it: a constant False would
let XLA fold the select away and contract ``err_decay * err + x`` into a
fused multiply-add that the train step never computes. omega = 1/3
exercises the posterior at a world that is not a power of two."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import aggregate as jagg  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.kernels.compress import kernel as jpk  # noqa: E402
from repro.kernels.compress import ops as jops  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import state_from_jax, state_to_jax  # noqa: E402
from repro_torch.core import aggregate, sparsify  # noqa: E402
from repro_torch.core.numerics import regularizer_factor  # noqa: E402
from repro_torch.kernels.compress import kernel as pk  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
J = 3 * 4096 + 517           # ragged: the port pads nothing
SPARSITY, MU, DECAY, MOMENTUM = 0.01, 0.5, 0.9, 0.9
MASK = (True, False, True)   # participation over the 3 compress steps


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


def _gauss(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _dyadic(rng, *shape):
    return (rng.integers(-1024, 1025, shape) * 2.0 ** -8).astype(np.float32)


def _cfgs(**kw):
    kw = dict(dict(kind="regtopk", sparsity=SPARSITY, mu=MU,
                   err_decay=DECAY, pipeline="reference",
                   comm_mode="simulate"), **kw)
    return jbase.SparsifierConfig(**kw), tbase.SparsifierConfig(**kw)


def _same_state(jst, tst, ctx, zero_sign=True):
    got = state_to_jax(tst)
    assert set(got) == set(jst), ctx
    for key, val in got.items():
        assert _same(np.asarray(jst[key]), val, zero_sign), (ctx, key)


def _bit(p: bool) -> torch.Tensor:
    return torch.tensor(bool(p))


# ---------------------------------------------------------------------------
# B1's gated form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "dgc"])
@pytest.mark.parametrize("gate", [0, 1])
def test_sweep1_gated_plain_matches_pallas(mode, gate):
    """The gated plain version against the reference's masked inputs and
    its Pallas sweep 1 (``gate=`` in dgc mode), at a ragged J: a, score,
    amax, hist and mom' bitwise. Some err entries are -0.0, whose decayed
    value plus a zero must be +0.0. Gate 1 gives the ungated bits."""
    dgc = mode == "dgc"
    rng = np.random.default_rng(10 * gate + dgc)
    g, err, mom = _gauss(rng, J), _gauss(rng, J, scale=0.1), _gauss(rng, J)
    err[::97] = -0.0
    c = np.float32(regularizer_factor(0.0, MU))
    jpad = pk.rows_of(J) * pk.BLOCK

    @jax.jit
    def ref(g, err, mom, p):
        ge, ee, pf = jops.masked_inputs(g, err, p, DECAY)
        pad = lambda x: jnp.pad(x, (0, jpad - J))  # noqa: E731
        a, score, mo, amax, hist = jpk.sweep1_pallas(
            pad(ge), pad(ee), c, mode=mode, momentum=MOMENTUM,
            mom=pad(mom) if dgc else None, gate=pf if dgc else None,
            interpret=True)
        out = (a[:J], score[:J], amax, hist.at[0].add(-(jpad - J)))
        return out + ((mo[:J],) if dgc else ())

    want = ref(*(jnp.asarray(x) for x in (g, err, mom)),
               jnp.asarray(bool(gate)))
    args = [torch.from_numpy(x) for x in (g, err)]
    tc = torch.tensor([c])
    tmom = torch.from_numpy(mom) if dgc else None
    got = pk.sweep1_gated(*args, tc, torch.tensor([float(gate)]), DECAY,
                          tmom, MOMENTUM)
    assert len(got) == len(want)
    for name, w, x in zip(("a", "score", "amax", "hist", "mom"), want, got):
        assert _same(w, x), name
    if gate:
        ungated = pk.sweep1(*args, tc, tmom, MOMENTUM)
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   if x.dtype == torch.float32 else torch.equal(x, y)
                   for x, y in zip(got, ungated))
    else:
        assert not np.signbit(got[0].numpy()[::97]).any()


# ---------------------------------------------------------------------------
# compress(participate=)
# ---------------------------------------------------------------------------

COMPRESS_CASES = [
    ("topk", dict(), "gauss"), ("dgc", dict(), "gauss"),
    ("regtopk", dict(), "gauss"),
    ("regtopk", dict(state_format="sparse"), "gauss"),
    ("topk", dict(pipeline="fused", comm_mode="sparse"), "gauss"),
    ("dgc", dict(pipeline="fused", comm_mode="sparse"), "gauss"),
    ("regtopk", dict(pipeline="fused", comm_mode="sparse"), "gauss"),
    # every |g| equal: the fused trim takes its exact fallback
    ("dgc", dict(pipeline="fused", comm_mode="sparse"), "tie"),
    ("regtopk", dict(pipeline="fused", comm_mode="sparse"), "tie"),
]
FROZEN = {"fused": ("idx_prev", "a_prev_sel", "g_prev_sel"),
          "dense": ("a_prev", "s_prev", "g_agg_prev"),
          "sparse": ("idx_prev", "a_prev_sel", "g_prev_sel")}


@pytest.mark.parametrize("kind,fields,case", COMPRESS_CASES)
def test_compress_under_participation_matches_reference(kind, fields, case):
    """3 steps of compress + observe_aggregate with participation (1, 0,
    1), err_decay 0.9, omega 1/3, against the jitted reference: packed
    pairs, count, dense ghat and mask, every state vector bitwise. A true
    bit gives the bits of no bit; at the false step the payload is
    inert, the error decays, DGC's momentum advances to momentum * mom
    and REGTOP-k's posterior stays as it was."""
    jcfg, tcfg = _cfgs(kind=kind, **fields)
    omega = 1 / 3
    layout = ("fused" if tcfg.pipeline == "fused" else tcfg.state_format)

    @jax.jit
    def jstep(st, g, g_agg, p):
        o = jsp.compress(jcfg, st, g, omega=omega, participate=p)
        return (o.values, o.indices, o.count, jsp.dense_ghat(o, J),
                jsp.dense_mask(o, J),
                jsp.observe_aggregate(jcfg, o.state, g_agg, participate=p))

    rng = np.random.default_rng(COMPRESS_CASES.index((kind, fields, case)))
    jst = jsp.init_state(jcfg, J)
    tst = sparsify.init_state(tcfg, J, "cpu")
    ek = sparsify.err_key(tcfg)
    fallbacks = []
    for t, p in enumerate(MASK):
        g = (_gauss(rng, J) if case == "gauss" else
             np.where(rng.random(J) < 0.5, -1.0, 1.0).astype(np.float32))
        g_agg = _gauss(rng, J, scale=0.5)
        vals, idx, cnt, ghat, mask, jst = jstep(
            jst, jnp.asarray(g), jnp.asarray(g_agg), jnp.asarray(p))
        tg = torch.from_numpy(g)
        out = sparsify.compress(tcfg, tst, tg, omega=omega,
                                participate=_bit(p))
        fallbacks.append(out.fallback)
        new = sparsify.observe_aggregate(tcfg, out.state,
                                         torch.from_numpy(g_agg),
                                         participate=_bit(p))
        assert _same(vals, out.values) and _same(idx, out.indices), t
        assert int(cnt) == int(out.count), t
        assert _same(ghat, sparsify.dense_ghat(out, J)), t
        assert _same(mask, sparsify.dense_mask(out, J)), t
        _same_state(jax.device_get(jst), new, t)
        if p:
            plain = sparsify.compress(tcfg, tst, tg, omega=omega)
            assert torch.equal(plain.values, out.values)
            assert torch.equal(plain.indices, out.indices)
            for key, val in plain.state.items():
                assert _same(val.numpy(), out.state[key]), (t, key)
        else:
            assert not out.values.any() and not out.indices.any()
            assert int(out.count) == 0
            want_err = np.float32(DECAY) * tst[ek].numpy() + np.float32(0)
            assert _same(want_err, new[ek]), t
            if kind == "dgc":
                want_mom = (np.float32(MOMENTUM) * tst["mom"].numpy()
                            + np.float32(0))
                assert _same(want_mom, new["mom"]), t
            for key in FROZEN[layout] if kind == "regtopk" else ():
                assert torch.equal(tst[key], new[key]), (t, key)
        tst = new
    if case == "tie":
        assert all(fallbacks), fallbacks


# ---------------------------------------------------------------------------
# round(participate=)
# ---------------------------------------------------------------------------

ROUND_CASES = [
    (dict(pipeline="fused", comm_mode="sparse"), "mean"),
    (dict(), "support"),                                  # dense posterior
    (dict(kind="dgc"), "mean"),
    (dict(kind="topk", pipeline="fused", comm_mode="sparse"), "support"),
]
ROUND_MASKS = [(True, False, True), (False, False, False),
               (False, True, True)]


@pytest.mark.parametrize("case", range(len(ROUND_CASES)))
def test_round_under_participation_matches_reference(case):
    """round() over 3 in-process workers with three masks, the second
    all-absent (g_agg = 0, every state decays), against the reference's
    GradientSync.round: g_agg and every state bitwise."""
    fields, combine = ROUND_CASES[case]
    jcfg, tcfg = _cfgs(combine=combine, **fields)
    n = 3
    rnd = jax.jit(lambda sts, gs, ps: jagg.GradientSync(jcfg, None).round(
        sts, gs, participate=ps))
    rng = np.random.default_rng(60 + case)
    jstates = [jsp.init_state(jcfg, J) for _ in range(n)]
    tstates = [sparsify.init_state(tcfg, J, "cpu") for _ in range(n)]
    sync = aggregate.GradientSync(tcfg)
    for t, mask in enumerate(ROUND_MASKS):
        grads = [_gauss(rng, J) for _ in range(n)]
        jg, jstates = rnd(jstates, [jnp.asarray(x) for x in grads],
                          [jnp.asarray(b) for b in mask])
        tg, tstates = sync.round(tstates, [torch.from_numpy(x)
                                           for x in grads],
                                 participate=[_bit(b) for b in mask])
        assert _same(jg, tg), t
        if not any(mask):
            assert not tg.any()
        for js, ts in zip(jstates, tstates):
            _same_state(jax.device_get(js), ts, t)


# ---------------------------------------------------------------------------
# gloo worlds of 3, 4 and 8
# ---------------------------------------------------------------------------

GLOO_T = 3
# seeds whose iid:0.3 draws take some worker out within GLOO_T steps
GLOO_SCHEDULE = {3: "iid:0.3,seed=1", 4: "iid:0.3,seed=2",
                 8: "iid:0.3,seed=3"}
# the two configs, as tests/torch_gloo_worker.py's mode "elastic" runs
# them and tests/jax_mesh_worker.py's cases spell them
GLOO_CASES = {"sparse": dict(pipeline="fused", comm_mode="sparse"),
              "simulate": dict(pipeline="reference", comm_mode="simulate")}


def _run_world(tmp_path, mode, world, reference=None, **data):
    """The port's gloo ranks, and with ``reference`` (cases) the
    reference's per-step sync on a mesh of ``world`` host devices
    (tests/jax_mesh_worker.py) side by side; returns the ranks' results
    (and the reference's)."""
    inp = tmp_path / "inputs.npz"
    np.savez(inp, sparsity=SPARSITY, mu=MU, **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"), mode,
         str(r), str(world), str(tmp_path / "rendezvous"), str(inp),
         str(tmp_path / f"rank{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    if reference is not None:
        ref_inp = tmp_path / "reference_inputs.npz"
        np.savez(ref_inp, sparsity=SPARSITY, mu=MU, cases=json.dumps(
            reference), **data)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "jax_mesh_worker.py"),
             str(world), str(ref_inp), str(tmp_path / "reference.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    if reference is None:
        return ranks
    return ranks, dict(np.load(tmp_path / "reference.npz"))


@pytest.mark.parametrize("world", [3, 4, 8])
def test_gloo_elastic_sync_matches_reference_round(tmp_path, world):
    """Each rank of a gloo group draws its own iid participation bits and
    syncs REGTOP-k (err_decay 0.9) with sparse comm on the fused pipeline
    (Gaussian gradients) and with simulate comm on the reference pipeline
    (dyadic gradients, whose sums are exact in gloo's order), in one
    spawn of the world. Against the reference under the reference's
    participation matrix: its round (worlds 3 and 4), or its per-step
    sync on a mesh of 8 host devices (tests/jax_mesh_worker.py, each
    device a rank with its bit): the bits, n_active on every rank, g_agg
    identical on every rank and bitwise equal to the reference's, and
    every final state bitwise. The simulate combine sums where(p, ghat,
    0), +0.0 for a sitting-out worker where the reference's round adds
    that worker's inert mask * a (-0.0 at a < 0): there g_agg and the
    dense posterior's copy of it are compared up to the sign of zero."""
    spec = GLOO_SCHEDULE[world]
    matrix = jfaults.participation_matrix(jfaults.parse_schedule(spec),
                                          GLOO_T, world)
    assert not matrix.all()
    rng = np.random.default_rng(70 + world)
    grads = {"sparse": _gauss(rng, GLOO_T, world, J),
             "simulate": _dyadic(rng, GLOO_T, world, J)}
    data = dict(kind="regtopk", err_decay=DECAY, schedule=spec,
                grads_sparse=grads["sparse"],
                grads_simulate=grads["simulate"])
    if world == 8:
        cases = {name: [dict(fields, kind="regtopk", err_decay=DECAY), True]
                 for name, fields in GLOO_CASES.items()}
        ranks, mesh = _run_world(tmp_path, "elastic", world, cases,
                                 parts=matrix, **data)
    else:
        ranks = _run_world(tmp_path, "elastic", world, **data)
    for name, fields in GLOO_CASES.items():
        signed = name == "sparse"
        if world == 8:
            want = [mesh[f"{name}_g_agg_{t}"] for t in range(GLOO_T)]
            finals = [{key[len(name) + 7:]: val[r]
                       for key, val in mesh.items()
                       if key.startswith(f"{name}_state_")}
                      for r in range(world)]
            for t in range(GLOO_T):
                assert np.all(mesh[f"{name}_n_active_{t}"]
                              == matrix[t].sum())
        else:
            want, finals = _round_reference(fields, grads[name], matrix,
                                            world)
        for t in range(GLOO_T):
            first = ranks[0][f"{name}_g_agg_{t}"]
            for r, res in enumerate(ranks):
                assert bool(res[f"{name}_part_{t}"]) == matrix[t, r]
                assert float(res[f"{name}_n_active_{t}"]) == \
                    matrix[t].sum(), (name, t, r)
                got = res[f"{name}_g_agg_{t}"]
                assert _same(first, got), (name, t, r)
                ref = want[t] if world != 8 else want[t][r]
                assert _same(ref, got, signed), (name, t, r)
        for r, res in enumerate(ranks):
            assert not bool(res["jax_imported"])
            assert set(finals[r]) == {key[len(name) + 7:] for key in res
                                      if key.startswith(f"{name}_state_")}
            for key, val in finals[r].items():
                got = res[f"{name}_state_{key}"]
                assert _same(np.asarray(val), got,
                             signed or key != "g_agg_prev"), (name, r, key)


def _round_reference(fields, grads, matrix, world):
    """The reference's jitted round under the participation matrix:
    g_agg of every step and every worker's final state."""
    jcfg, _ = _cfgs(**fields)
    rnd = jax.jit(lambda sts, gs, ps: jagg.GradientSync(
        jcfg, None).round(sts, gs, participate=ps))
    states = [jsp.init_state(jcfg, J) for _ in range(world)]
    want = []
    for t in range(GLOO_T):
        g_agg, states = rnd(states, [jnp.asarray(x) for x in grads[t]],
                            [jnp.asarray(b) for b in matrix[t]])
        want.append(np.asarray(g_agg))
    return want, [jax.device_get(st) for st in states]


# ---------------------------------------------------------------------------
# the non-finite guard
# ---------------------------------------------------------------------------

def _jax_sync(cfg, st):
    mesh = jax.make_mesh((1,), ("data",))

    def f(g_, st_, p_):
        return jagg.GradientSync(cfg, ("data",))(st_, g_, participate=p_,
                                                 with_stats=True)

    spec = jax.tree_util.tree_map(lambda _: P(), st)
    stats = {"n_active": P(), "dropped_nonfinite": P()}
    with mesh:
        return mesh, jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("data"), spec, P()),
            out_specs=(P("data"), spec, stats), check_vma=False))


@pytest.mark.parametrize("fields,drops", [
    (dict(), [0, 1, 1]),                          # the dense ghat guard
    (dict(kind="topk", comm_mode="sparse"), [0, 1, 1]),   # packed values
    (dict(pipeline="fused", comm_mode="sparse"), [0, 0, 0])])
def test_nonfinite_guard_matches_reference(fields, drops, monkeypatch):
    """A NaN in the gradient at step 1 of 3 (world 1): the sync against
    the reference's per-step path, g_agg, state, n_active and
    dropped_nonfinite bitwise. On the reference pipeline the exact top-k
    ranks the NaN first: the worker is dropped for the step (n_active 0,
    g_agg 0), and again at step 2, since its error a - ghat at the NaN
    is NaN. The fused pipeline runs the reference's Pallas path (the
    TPU's, which the port's kernels follow; its XLA strategy, the CPU
    default, ranks a NaN candidate in): sweep 2's |score| >= tau never
    takes the NaN, so nothing is dropped there."""
    jcfg, tcfg = _cfgs(**fields)
    monkeypatch.setattr(jops, "default_strategy", lambda: "pallas_interpret")
    jst = jsp.init_state(jcfg, J)
    tst = state_from_jax(jax.device_get(jst))
    mesh, fn = _jax_sync(jcfg, jst)
    sync = aggregate.GradientSync(tcfg)
    rng = np.random.default_rng(80)
    dropped = []
    for t in range(3):
        g = _gauss(rng, J)
        if t == 1:
            g[1234] = np.nan
        with mesh:
            jg, jst, jstats = fn(jnp.asarray(g), jst, jnp.asarray(True))
        tg, tst, tstats = sync(tst, torch.from_numpy(g),
                               participate=_bit(True), with_stats=True)
        assert _same(jg, tg), t
        _same_state(jax.device_get(jst), tst, t)
        for key in ("n_active", "dropped_nonfinite"):
            assert float(jstats[key]) == float(tstats[key]), (t, key)
        dropped.append(float(tstats["dropped_nonfinite"]))
    assert dropped == drops


# ---------------------------------------------------------------------------
# the train step and the launcher
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-5             # as tests/test_torch_train.py


def test_train_step_under_a_fault_schedule_matches_reference():
    """3 steps of both train steps at reduced width (REGTOP-k, fused,
    sparse comm, err_decay 0.9) under ``bursty:period=3,outage=1``: world
    1 sits out step 0. Losses within the train tests' tolerance, and
    n_active [0, 1, 1] and dropped_nonfinite equal."""
    from repro.launch.mesh import make_mesh
    from repro.train.step import build_parallel
    from repro.train.step import build_train_step as jbuild
    from repro.train.step import init_train_state as jinit
    from repro_torch.convert import params_from_jax
    from repro_torch.train.step import build_train_step, init_train_state
    spec = "bursty:period=3,outage=1,workers=0"

    def run_cfg(mod):
        return mod.RunConfig(
            model=mod.reduced_config(mod.get_config("stablelm-3b")),
            shape=mod.SHAPES["train_4k"],
            sparsifier=mod.SparsifierConfig(
                kind="regtopk", sparsity=SPARSITY, mu=MU, err_decay=DECAY,
                comm_mode="sparse", pipeline="fused"),
            optimizer=mod.OptimizerConfig(kind="adam", lr=1e-3), seed=0,
            steps=3, fault_schedule=spec)

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 32)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((4, 1), np.int32)], 1)
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    with mesh:
        params, opt, ef = jinit(run_cfg(jbase), mesh, pal,
                                jax.random.PRNGKey(0))
        jstep = jax.jit(jbuild(run_cfg(jbase), mesh, pal)[0])
        tstate = init_train_state(run_cfg(tbase), "cpu",
                                  params=params_from_jax(
                                      jax.device_get(params)))
        tstep = build_train_step(run_cfg(tbase), "cpu")
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
            for key in ("n_active", "dropped_nonfinite"):
                assert float(tm[key]) == float(m[key]), (t, key)
            active.append(float(tm["n_active"]))
    assert active == [0.0, 1.0, 1.0]


def test_launcher_elastic_flags_match_the_reference_launcher():
    """--fault-schedule, --drop-prob, --err-decay and --combine with the
    reference launcher's defaults and conflict check; a short run logs
    the live worker count."""
    from repro.launch.train import parse_args as jparse
    from repro_torch.launch.train import main, parse_args, run_config, train
    argv = ["--arch", "stablelm-3b", "--smoke"]
    ours, theirs = parse_args(argv), jparse(argv)
    for name in ("fault_schedule", "drop_prob", "err_decay", "combine"):
        assert getattr(ours, name) == getattr(theirs, name), name
    with pytest.raises(SystemExit, match="conflicts"):
        run_config(parse_args(argv + ["--drop-prob", "0.3",
                                      "--fault-schedule", "iid:0.1"]))
    with pytest.raises(ValueError):
        run_config(parse_args(argv + ["--fault-schedule", "bursty:x=1"]))
    run = run_config(parse_args(argv + ["--drop-prob", "0.3", "--err-decay",
                                        "0.9", "--combine", "support",
                                        "--steps", "3", "--log-every", "1"]))
    assert run.fault_schedule == "iid:0.3"
    assert (run.sparsifier.err_decay, run.sparsifier.combine) == (0.9,
                                                                  "support")
    logs = []
    out = train(run, device="cpu", batch=2, seq=16, fixed_batch=True,
                log=logs.append)
    assert [rec["n_active"] for rec in out["history"]] == [0.0, 1.0, 0.0]
    assert any("fault schedule: iid:0.3,seed=0" in s for s in logs)
    assert any("active 1" in s for s in logs)
    assert main(argv + ["--device", "cpu", "--steps", "1", "--batch", "2",
                        "--seq", "16", "--fault-schedule",
                        "permanent:step=0"]) == 0


def test_sketch_selection_refuses_a_mask():
    """The elastic sketch semantics are served (ROADMAP A12 with A10; a
    mask raised before): a participation bit, a round mask, err_decay
    and combine="support" build and run, and so does a train step under
    a fault schedule, with n_active in its metrics. Only an unknown
    combine raises, the reference's ValueError."""
    from repro_torch.train.step import build_train_step, init_train_state
    _, cfg = _cfgs(kind="sketchtopk", err_decay=1.0)
    sync = aggregate.GradientSync(cfg)
    st = sparsify.init_state(cfg, 64, "cpu")
    _, new = sync(st, torch.ones(64), participate=_bit(False))
    assert torch.equal(new["err"], st["err"])
    g_agg, _ = sync.round([st], [torch.ones(64)], participate=[False])
    assert not g_agg.any()
    for elastic in (dict(err_decay=0.9), dict(combine="support")):
        aggregate.GradientSync(dataclasses.replace(cfg, **elastic))
    run = tbase.RunConfig(
        model=tbase.reduced_config(tbase.get_config("stablelm-3b")),
        shape=tbase.SHAPES["train_4k"], sparsifier=cfg,
        fault_schedule="iid:0.2")
    state = init_train_state(run, "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 16))).long()
    _, metrics = build_train_step(run, "cpu")(
        state, {"tokens": tokens, "targets": tokens})
    assert float(metrics["n_active"]) in (0.0, 1.0)
    with pytest.raises(ValueError, match="combine"):
        aggregate.GradientSync(tbase.SparsifierConfig(combine="median"))
