"""The port's data-parallel training step against the reference's
``build_train_step`` on a 1x1 mesh: reduced StableLM-3B, REGTOP-k fused
sparse sync, sketchtopk, DGC on both pipelines, and the reference
launcher's default config (REGTOP-k on the reference pipeline, dense
posterior, simulate comm), Adam (and clipped sgd with a warmup-cosine
rate), one fixed numpy batch, the same initial weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.flatten import TreeFlattener as JaxFlattener  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.train.step import build_parallel  # noqa: E402
from repro.train.step import build_train_step as jax_build_train_step  # noqa: E402
from repro.train.step import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.flatten import TreeFlattener  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.train.step import build_train_step, init_train_state  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

STEPS = 3
# loss: fp32 forward on both sides, summed in different orders (~1e-7
# relative), so 1e-5 relative.
LOSS_RTOL = 1e-5
# params: Adam moves each selected coordinate by ~lr = 1e-3 per step with
# the update normalised by the gradient's own scale, so gradient drift of
# ~1e-6 relative moves params by ~1e-9; 1e-5 absolute leaves margin and
# still catches any coordinate moved or not moved differently.
PARAM_ATOL = 1e-5


def _run_cfgs(mod, sparsity=0.01, mu=0.5, kind="regtopk",
              comm_mode="sparse", pipeline="fused", optimizer=None):
    cfg = mod.reduced_config(mod.get_config("stablelm-3b"))
    return mod.RunConfig(
        model=cfg, shape=mod.SHAPES["train_4k"],
        sparsifier=mod.SparsifierConfig(kind=kind, sparsity=sparsity,
                                        mu=mu, comm_mode=comm_mode,
                                        pipeline=pipeline),
        optimizer=mod.OptimizerConfig(**(optimizer or dict(kind="adam",
                                                           lr=1e-3))),
        seed=0, steps=STEPS)


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 32)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((4, 1), np.int32)], 1)
    return tokens, targets


def test_three_steps_match_reference():
    jrun, trun = _run_cfgs(jbase), _run_cfgs(tbase)
    tokens, targets = _batch()
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    with mesh:
        params, opt, ef = jax_init_train_state(jrun, mesh, pal,
                                               jax.random.PRNGKey(0))
        step_fn, _, _ = jax_build_train_step(jrun, mesh, pal)
        jstep = jax.jit(step_fn)
        tstate = init_train_state(trun, "cpu",
                                  params=params_from_jax(
                                      jax.device_get(params)))
        tstep = build_train_step(trun, "cpu")
        jbatch = {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)}
        tbatch = {"tokens": torch.from_numpy(tokens).long(),
                  "targets": torch.from_numpy(targets).long()}
        for t in range(STEPS):
            params, opt, ef, metrics = jstep(params, opt, ef, jbatch,
                                             jax.random.PRNGKey(0))
            tstate, tmetrics = tstep(tstate, tbatch)
            np.testing.assert_allclose(float(tmetrics["loss"]),
                                       float(metrics["loss"]),
                                       rtol=LOSS_RTOL)
            want = np.sort(np.asarray(ef["idx_prev"]).reshape(-1))
            got = np.sort(tstate.ef["idx_prev"].numpy().view(np.uint32))
            assert np.array_equal(want, got), t
        jflat = np.asarray(JaxFlattener(params).flatten(params))
    tflat = TreeFlattener(tstate.params).flatten(tstate.params)
    np.testing.assert_allclose(tflat.detach().numpy(), jflat, rtol=0,
                               atol=PARAM_ATOL)


def test_three_sketch_steps_match_reference():
    """The sketch-coordinated path (kind="sketchtopk", fused pipeline)
    through both train steps. The reference step returns no g_agg, so the
    support is compared through the error state: err_prev is a with the
    selected entries zeroed, so its zero set is the selected support
    together with the entries whose a is exactly zero (embedding rows of
    tokens not in the batch), which the two models share; the count of
    nonzero g_agg entries is compared as well."""
    _steps_match_reference(dict(kind="sketchtopk"), "err_prev")


def test_three_sketch_reference_steps_match_reference():
    """kind="sketchtopk" at the launcher's other defaults (reference
    pipeline, exact selector, simulate comm): the encode kernel B4's path
    and the apply kernel, compared as the fused sketch path above through
    the zero set of the error state ("err" on this pipeline) and the
    count of nonzero g_agg entries."""
    kw = dict(kind="sketchtopk", comm_mode="simulate", pipeline="reference")
    assert _run_cfgs(tbase, **kw).sparsifier.selector == "exact"
    _steps_match_reference(kw, "err")


def test_reference_sketch_encode_passes_the_sync_tables(monkeypatch):
    """GradientSync.encode on the reference pipeline hands its own
    ``sketch_tables`` to ``sketch.encode``, so a run builds B4's start
    table once; on the CPU the plain version runs and the dict stays
    empty."""
    from repro_torch.core import aggregate, sketch, sparsify
    cfg = tbase.SparsifierConfig(kind="sketchtopk", sparsity=0.01,
                                 comm_mode="simulate", pipeline="reference")
    sync = aggregate.GradientSync(cfg)
    j = 3 * 4096 + 517
    state = sparsify.init_state(cfg, j, "cpu")
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(j)
                         .astype(np.float32))
    seen = []
    encode = sketch.encode

    def spy(a, rows, width, tables=None):
        seen.append(tables)
        return encode(a, rows, width, tables)
    monkeypatch.setattr(sketch, "encode", spy)
    a, sk = sync.encode(state, g)
    assert len(seen) == 1 and seen[0] is sync.sketch_tables
    assert sync.sketch_tables == {}
    assert torch.equal(sk, encode(a, cfg.sketch_rows, sk.shape[1]))


@pytest.mark.parametrize("pipeline,comm_mode", [("fused", "sparse"),
                                                ("reference", "simulate")])
def test_three_dgc_steps_match_reference(pipeline, comm_mode):
    """kind="dgc" (momentum 0.9) through both train steps, on the fused
    pipeline with sparse comm (kernels B1 in its dgc mode and B2) and on
    the reference pipeline with the launchers' other defaults (the apply
    kernel B6); the selection compared through the zero set of the error
    state, the momentum through its own zero set, which is the same
    support with the entries whose momentum is exactly zero."""
    kw = dict(kind="dgc", comm_mode=comm_mode, pipeline=pipeline)
    key = "err_prev" if pipeline == "fused" else "err"
    _steps_match_reference(kw, key, ("mom",))


def test_three_clipped_sgd_steps_match_reference():
    """The train step hands the optimizer the global norm of g_agg when
    ``grad_clip`` is set, as the reference's step does: sgd with a clip
    that acts (the norm is well above 1e-3) and a warmup-cosine rate, on
    the main path (REGTOP-k, fused, sparse comm)."""
    opt = dict(kind="sgd", lr=0.5, grad_clip=1e-3, warmup_steps=2,
               schedule="cosine", total_steps=4)
    _steps_match_reference(dict(optimizer=opt), "err_prev")


def _steps_match_reference(kw: dict, key: str, zero_sets=()):
    """STEPS train steps of both packages on the config ``kw``: the loss,
    the zero set of the state vector ``key`` (and of ``zero_sets``), the
    count of nonzero g_agg entries and the final params."""
    jrun = _run_cfgs(jbase, **kw)
    trun = _run_cfgs(tbase, **kw)
    tokens, targets = _batch()
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    with mesh:
        params, opt, ef = jax_init_train_state(jrun, mesh, pal,
                                               jax.random.PRNGKey(0))
        step_fn, _, _ = jax_build_train_step(jrun, mesh, pal)
        jstep = jax.jit(step_fn)
        tstate = init_train_state(trun, "cpu",
                                  params=params_from_jax(
                                      jax.device_get(params)))
        tstep = build_train_step(trun, "cpu")
        jbatch = {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)}
        tbatch = {"tokens": torch.from_numpy(tokens).long(),
                  "targets": torch.from_numpy(targets).long()}
        for t in range(STEPS):
            params, opt, ef, metrics = jstep(params, opt, ef, jbatch,
                                             jax.random.PRNGKey(0))
            tstate, tmetrics = tstep(tstate, tbatch)
            np.testing.assert_allclose(float(tmetrics["loss"]),
                                       float(metrics["loss"]),
                                       rtol=LOSS_RTOL)
            for name in (key,) + tuple(zero_sets):
                want = np.asarray(ef[name]).reshape(-1) == 0
                got = tstate.ef[name].numpy() == 0
                assert np.array_equal(want, got), (t, name)
            j = got.size
            assert round(float(tmetrics["agg_nonzero"]) * j) == \
                round(float(metrics["agg_nonzero"]) * j), t
        jflat = np.asarray(JaxFlattener(params).flatten(params))
    tflat = TreeFlattener(tstate.params).flatten(tstate.params)
    np.testing.assert_allclose(tflat.detach().numpy(), jflat, rtol=0,
                               atol=PARAM_ATOL)


def test_sketch_launcher_overfit_loss_falls():
    from repro_torch.launch.train import main, parse_args, run_config
    argv = ["--arch", "stablelm-3b", "--smoke", "--sparsifier", "sketchtopk",
            "--device", "cpu", "--fixed-batch", "--steps", "30",
            "--batch", "4", "--seq", "32"]
    run = run_config(parse_args(argv))
    assert run.sparsifier.kind == "sketchtopk"
    assert (run.sparsifier.sketch_rows, run.sparsifier.sketch_width) == (3, 0)
    out = train(run, device="cpu", batch=4, seq=32, fixed_batch=True,
                log=lambda msg: None)
    losses = [rec["loss"] for rec in out["history"]]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 1.0, losses
    assert main(argv[:-6] + ["--steps", "1", "--batch", "2", "--seq",
                             "16"]) == 0


def test_dgc_launcher_overfit_loss_falls():
    """``--sparsifier dgc`` at the launcher's other defaults (reference
    pipeline, simulate comm) and on the fused pipeline with sparse comm;
    ``--optimizer sgd`` runs too."""
    from repro_torch.launch.train import main, parse_args, run_config
    argv = ["--arch", "stablelm-3b", "--smoke", "--sparsifier", "dgc",
            "--device", "cpu", "--fixed-batch", "--steps", "30",
            "--batch", "4", "--seq", "32"]
    for extra in ([], ["--comm", "sparse", "--pipeline", "fused"]):
        run = run_config(parse_args(argv + extra))
        assert (run.sparsifier.kind, run.sparsifier.momentum) == ("dgc", 0.9)
        out = train(run, device="cpu", batch=4, seq=32, fixed_batch=True,
                    log=lambda msg: None)
        losses = [rec["loss"] for rec in out["history"]]
        assert all(np.isfinite(losses))
        assert losses[-1] < losses[0] - 1.0, (extra, losses)
    assert main(argv[:-6] + ["--optimizer", "sgd", "--steps", "2",
                             "--batch", "2", "--seq", "16"]) == 0


def test_fixed_batch_overfit_loss_falls():
    run = _run_cfgs(tbase)
    import dataclasses
    run = dataclasses.replace(run, steps=30, log_every=100)
    out = train(run, device="cpu", batch=4, seq=32, fixed_batch=True,
                log=lambda msg: None)
    losses = [rec["loss"] for rec in out["history"]]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 1.0, losses


def test_three_default_config_steps_match_reference():
    """The reference launcher's default config, SparsifierConfig(kind=
    "regtopk", pipeline="reference", state_format="dense", selector=
    "exact", comm_mode="simulate"): 3 steps through both train steps.
    The selection is compared through s_prev (the step's dense mask),
    loss and params within the tolerances above."""
    kw = dict(comm_mode="simulate", pipeline="reference")
    jrun, trun = _run_cfgs(jbase, **kw), _run_cfgs(tbase, **kw)
    assert trun.sparsifier.state_format == "dense"
    assert trun.sparsifier.selector == "exact"
    tokens, targets = _batch()
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    with mesh:
        params, opt, ef = jax_init_train_state(jrun, mesh, pal,
                                               jax.random.PRNGKey(0))
        step_fn, _, _ = jax_build_train_step(jrun, mesh, pal)
        jstep = jax.jit(step_fn)
        tstate = init_train_state(trun, "cpu",
                                  params=params_from_jax(
                                      jax.device_get(params)))
        tstep = build_train_step(trun, "cpu")
        jbatch = {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)}
        tbatch = {"tokens": torch.from_numpy(tokens).long(),
                  "targets": torch.from_numpy(targets).long()}
        for t in range(STEPS):
            params, opt, ef, metrics = jstep(params, opt, ef, jbatch,
                                             jax.random.PRNGKey(0))
            old = tstate
            tstate, tmetrics = tstep(tstate, tbatch)
            assert old.ef is None          # the step consumed it
            np.testing.assert_allclose(float(tmetrics["loss"]),
                                       float(metrics["loss"]),
                                       rtol=LOSS_RTOL)
            want = np.nonzero(np.asarray(ef["s_prev"]).reshape(-1))[0]
            got = np.nonzero(tstate.ef["s_prev"].numpy())[0]
            assert np.array_equal(want, got), t
            assert set(tstate.ef) == {"err", "a_prev", "s_prev",
                                      "g_agg_prev", "step"}
        jflat = np.asarray(JaxFlattener(params).flatten(params))
    tflat = TreeFlattener(tstate.params).flatten(tstate.params)
    np.testing.assert_allclose(tflat.detach().numpy(), jflat, rtol=0,
                               atol=PARAM_ATOL)


def test_launcher_defaults_are_the_references_and_overfit():
    """The launcher's defaults are the reference launcher's (simulate
    comm, reference pipeline, exact selector); at those defaults the loss
    falls on a fixed batch, and --selector histogram runs too."""
    from repro.launch.train import parse_args as jax_parse_args
    from repro_torch.launch.train import main, parse_args, run_config
    argv = ["--arch", "stablelm-3b", "--smoke"]
    ours, theirs = parse_args(argv), jax_parse_args(argv)
    for name in ("comm", "pipeline", "selector", "sparsifier", "sparsity",
                 "mu", "steps", "batch", "seq"):
        assert getattr(ours, name) == getattr(theirs, name), name
    run = run_config(parse_args(argv + ["--device", "cpu", "--steps", "30"]))
    sp = run.sparsifier
    assert (sp.kind, sp.pipeline, sp.state_format, sp.selector,
            sp.comm_mode) == ("regtopk", "reference", "dense", "exact",
                              "simulate")
    out = train(run, device="cpu", batch=4, seq=32, fixed_batch=True,
                log=lambda msg: None)
    losses = [rec["loss"] for rec in out["history"]]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 1.0, losses
    assert main(argv + ["--selector", "histogram", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "16"]) == 0
