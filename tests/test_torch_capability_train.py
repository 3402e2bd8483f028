"""The launcher's flags of the capability matrix (``--num-buckets``,
``--wire-dtype``, ``--selector histogram`` on the fused pipeline,
``--sparsifier randk`` and ``thresholdk``) through the port's launcher
config and train step against the reference launcher's config and train
step on a 1x1 mesh: 3 steps from the same weights on one fixed batch,
the losses within tests/test_torch_train.py's tolerance and the
parameters within its tolerance. randk draws with the reference's key
(the run's seed key folded with the data-parallel rank), so the same
coordinates move in both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402

LOSS_RTOL = 1e-5             # as tests/test_torch_train.py
PARAM_ATOL = 1e-5
FUSED = ["--comm", "sparse", "--pipeline", "fused"]


@pytest.mark.parametrize("flags", [
    ["--sparsifier", "randk"] + FUSED,
    ["--num-buckets", "8", "--wire-dtype", "bfloat16", "--selector",
     "histogram"] + FUSED,
    ["--sparsifier", "thresholdk", "--num-buckets", "3"]])
def test_launcher_flags_match_the_reference_train_step(flags):
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
    assert (sp.kind, sp.comm_mode, sp.pipeline, sp.selector, sp.num_buckets,
            sp.wire_dtype) == (ja.sparsifier, ja.comm, ja.pipeline,
                               ja.selector, ja.num_buckets, ja.wire_dtype)
    jrun = jbase.RunConfig(
        model=jbase.reduced_config(jbase.get_config("stablelm-3b")),
        shape=jbase.SHAPES["train_4k"],
        sparsifier=jbase.SparsifierConfig(
            kind=sp.kind, sparsity=sp.sparsity, mu=sp.mu,
            comm_mode=sp.comm_mode, pipeline=sp.pipeline,
            selector=sp.selector, num_buckets=sp.num_buckets,
            wire_dtype=sp.wire_dtype),
        optimizer=jbase.OptimizerConfig(kind=ja.optimizer, lr=ja.lr),
        seed=ja.seed, steps=3)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 32)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((4, 1), np.int32)], 1)
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    with mesh:
        params, opt, ef = jinit(jrun, mesh, pal, jax.random.PRNGKey(ja.seed))
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
        for _ in range(3):
            # the reference launcher passes its seed's key every step
            params, opt, ef, metrics = jstep(params, opt, ef, jbatch,
                                             jax.random.PRNGKey(ja.seed))
            tstate, tmetrics = tstep(tstate, tbatch)
            np.testing.assert_allclose(float(tmetrics["loss"]),
                                       float(metrics["loss"]),
                                       rtol=LOSS_RTOL)
            if sp.selector == "histogram":
                k = round(sp.sparsity * TreeFlattener(
                    tstate.params).total)
                assert k <= int(tstep.gsync.last_count) <= 2 * k
        jflat = np.asarray(JaxFlattener(params).flatten(params))
    tflat = TreeFlattener(tstate.params).flatten(tstate.params)
    diff = np.abs(tflat.detach().numpy() - jflat)
    assert diff.max() <= PARAM_ATOL, diff.max()
