"""The port's other dense layouts against the reference on the same
weights: reduced granite-8b (rmsnorm, GQA), qwen1.5-32b (rmsnorm, QKV
bias), starcoder2-7b (layernorm, GELU, QKV bias, GQA), a tied-embedding
variant without RoPE (sinusoidal positions) and granite's sliding-window
variant through ``RunConfig.attn_override``; the loss and the flat
gradient against the jitted reference, and one REGTOP-k fused sparse
train step of granite and starcoder2 through both train steps, with the
compressor bitwise on the reference's own gradient.

The weights come from the reference's init, carried across, with every
bias and norm scale moved off its init value (so that each term of the
forward is live) by numpy noise from a seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.core.flatten import TreeFlattener as JaxFlattener  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models.parallel import Parallel  # noqa: E402
from repro.train.step import build_parallel  # noqa: E402
from repro.train.step import build_train_step as jax_build_train_step  # noqa: E402
from repro.train.step import init_train_state as jax_init_train_state  # noqa: E402
from repro.train.step import resolve_model_cfg as jax_resolve  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.core.flatten import TreeFlattener, tree_items  # noqa: E402
from repro_torch.launch.train import parse_args, run_config, train  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.train.step import build_train_step, init_train_state  # noqa: E402

# fp32 on both sides, summed in different orders; the GELU's tanh is
# torch.tanh, a few ulp from XLA's: a few fp32 ulps of relative drift
RTOL, ATOL = 1e-5, 1e-6
LAYOUTS = ("granite-8b", "qwen1.5-32b", "starcoder2-7b", "tied-norope",
           "sliding")
WINDOW = 8                   # the sliding variant's, below the sequence


def _runs(layout: str, **sparsifier):
    """(reference, port) RunConfigs of a reduced layout; the sliding one
    is granite's with ``attn_override="sliding"``."""
    arch = {"tied-norope": "starcoder2-7b",
            "sliding": "granite-8b"}.get(layout, layout)
    out = []
    for mod in (jbase, tbase):
        cfg = mod.reduced_config(mod.get_config(arch))
        if layout == "tied-norope":
            cfg = dataclasses.replace(cfg, tie_embeddings=True, rope=False)
        if layout == "sliding":
            cfg = dataclasses.replace(cfg, window=WINDOW)
        out.append(mod.RunConfig(
            model=cfg, shape=mod.SHAPES["train_4k"],
            sparsifier=mod.SparsifierConfig(**sparsifier),
            optimizer=mod.OptimizerConfig(kind="adam", lr=1e-3), seed=0,
            steps=1, attn_override="sliding" if layout == "sliding" else ""))
    return out


BIASES = {"scale", "bias", "bq", "bk", "bv", "up_b", "down_b"}


def _live(jparams, seed=0):
    """The reference's parameters (numpy) with every bias and norm scale
    moved by N(0, 0.1^2) noise."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if path[-1].key in BIASES:
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(move, jax.device_get(jparams))


def _batch(batch=2, seq=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, (batch, seq)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((batch, 1), np.int32)],
                             1)
    return tokens, targets


def test_sliding_override_resolves_like_the_reference():
    jrun, trun = _runs("sliding")
    jcfg, tcfg = jax_resolve(jrun), tbase.resolve_model_cfg(trun)
    assert (jcfg.attn_kind, jcfg.window) == (tcfg.attn_kind, tcfg.window) \
        == ("sliding", WINDOW)
    full = dataclasses.replace(trun, attn_override="")
    assert tbase.resolve_model_cfg(full) is full.model


@pytest.mark.parametrize("layout", LAYOUTS)
def test_loss_and_gradient_match_reference(layout, batch=2, seq=24):
    jrun, trun = _runs(layout)
    jcfg, tcfg = jax_resolve(jrun), tbase.resolve_model_cfg(trun)
    jparams = _live(jax_init_params(jcfg, Parallel(), jax.random.PRNGKey(0)))
    tokens, targets = _batch(batch, seq)
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, batch, jcfg, Parallel()), has_aux=True))(
            jparams)
    jflat = np.asarray(JaxFlattener(jparams).flatten(jgrads))
    tparams = params_from_jax(jparams)
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_items(tparams)]
    loss = loss_fn(tparams, {"tokens": torch.from_numpy(tokens).long(),
                             "targets": torch.from_numpy(targets).long()},
                   tcfg)
    grads = torch.autograd.grad(loss, leaves)
    tflat = TreeFlattener(tparams).flatten(list(grads)).numpy()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(tflat, jflat, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["granite-8b", "sliding"])
def test_ragged_length_matches_reference(layout):
    """A length of 1100, past one query chunk (1024) and not a multiple of
    it: the port's last query chunk is short, the reference takes its
    one-softmax form; loss and flat gradient within RTOL."""
    test_loss_and_gradient_match_reference(layout, batch=1, seq=1100)


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("seq", [1100, 2100])
def test_attention_tail_chunks_match_reference(seq, window):
    """``causal_attention`` against the reference's ``_sdpa_chunked`` on
    the same q, k, v (GQA, 4 heads over 2): at 2100 the last query chunk
    (52) and the last key chunk (52, after 2048) are both short; causal
    and within a window."""
    from repro.models.attention import _sdpa_chunked
    from repro_torch.models.attention import causal_attention
    rng = np.random.default_rng(seq + window)
    q, k, v = (rng.standard_normal((1, seq, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    pos = jnp.arange(seq)
    want = np.asarray(jax.jit(lambda q, k, v: _sdpa_chunked(
        q, k, v, pos, pos, 0.25, True, window))(q, k, v))
    got = causal_attention(*(torch.from_numpy(t) for t in (q, k, v)), 0.25,
                           window).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["granite-8b", "starcoder2-7b"])
def test_fused_step_matches_reference(layout):
    """The main path (REGTOP-k, fused pipeline, sparse comm) on a new
    layout: the compressor on the reference's own flat gradient is
    bitwise (values, indices and every state vector); one train step of
    each package on the same weights and batch selects the same support
    (``idx_prev`` equal) and zeroes the same entries of the error state,
    with the same loss."""
    kw = dict(kind="regtopk", sparsity=0.01, mu=0.5, pipeline="fused",
              comm_mode="sparse")
    jrun, trun = _runs(layout, **kw)
    tokens, targets = _batch(4, 32)
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    with mesh:
        params, opt, ef = jax_init_train_state(jrun, mesh, pal,
                                               jax.random.PRNGKey(0))
        live = _live(params)
        params = jax.tree_util.tree_map(jnp.asarray, live)
        jbatch = {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)}
        jgrads = jax.jit(jax.grad(lambda p: jax_loss_fn(
            p, jbatch, jrun.model, Parallel())[0]))(params)
        g = np.asarray(JaxFlattener(params).flatten(jgrads))
        def jax_compress(st, gg):
            out = jsp.compress(jrun.sparsifier, st, gg)
            return out.values, out.indices, out.state
        jvalues, jindices, jstate = jax.jit(jax_compress)(
            jsp.init_state(jrun.sparsifier, g.size), jnp.asarray(g))
        tout = tsp.compress(trun.sparsifier,
                            tsp.init_state(trun.sparsifier, g.size, "cpu"),
                            torch.from_numpy(np.array(g)))
        assert np.array_equal(np.asarray(jindices).view(np.int32),
                              tout.indices.numpy())
        assert np.array_equal(np.asarray(jvalues).view(np.int32),
                              tout.values.numpy().view(np.int32))
        assert sorted(jstate) == sorted(tout.state)
        for key, val in jstate.items():
            want = np.asarray(val)
            got = tout.state[key].numpy()
            assert np.array_equal(want.view(np.int32)
                                  if want.dtype != np.int32 else want,
                                  got.view(np.int32)), key

        step_fn, _, _ = jax_build_train_step(jrun, mesh, pal)
        params, opt, ef, metrics = jax.jit(step_fn)(
            params, opt, ef, jbatch, jax.random.PRNGKey(0))
    tstate = init_train_state(trun, "cpu", params=params_from_jax(live))
    tstate, tmetrics = build_train_step(trun, "cpu")(
        tstate, {"tokens": torch.from_numpy(tokens).long(),
                 "targets": torch.from_numpy(targets).long()})
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(metrics["loss"]), rtol=RTOL)
    want = np.sort(np.asarray(ef["idx_prev"]).reshape(-1))
    got = np.sort(tstate.ef["idx_prev"].numpy().view(np.uint32))
    assert np.array_equal(want, got)
    assert np.array_equal(np.asarray(ef["err_prev"]).reshape(-1) == 0,
                          tstate.ef["err_prev"].numpy() == 0)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen1.5-32b",
                                  "starcoder2-7b"])
def test_train_launcher_takes_the_dense_archs(arch):
    """``--arch`` names every dense config of the registry; the main path
    (REGTOP-k fused, sparse comm) trains each smoke model, the loss
    falling on a fixed batch."""
    run = run_config(parse_args(["--arch", arch, "--smoke", "--steps", "4",
                                 "--comm", "sparse", "--pipeline", "fused"]))
    assert run.model.name == f"{arch}-smoke"
    out = train(run, device="cpu", batch=2, seq=16, fixed_batch=True,
                log=lambda msg: None)
    losses = [rec["loss"] for rec in out["history"]]
    assert out["params"] == run.model.param_count()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
