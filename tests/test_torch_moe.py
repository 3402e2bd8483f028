"""The port's MoE FFN and the MoE family against the reference on the same
weights: the routing (experts, slots, kept choices) bit for bit on the
reference's own router logits, ``moe_fwd`` (the output and the three aux
terms, with drops, with a shared expert), reduced Granite-MoE's loss and
flat gradient (its flat J-vector bit for bit), prefill and decode
logits, one REGTOP-k fused sparse train step through both train steps
(the compressor bitwise on the reference's own gradient), the train
launcher, and the aux metrics' group means at a gloo world of 2.

The weights are drawn by the port's init and carried into the
reference's tree, with every norm scale moved off its init value by
numpy noise from a seed.
DeepSeek-V2-Lite (MLA, a shared expert, the dense prefix) has its own
file, tests/test_torch_mla.py."""
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

from repro.configs import base as jbase  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.core.flatten import TreeFlattener as JaxFlattener  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.parallel import Parallel  # noqa: E402
from repro.train.step import build_parallel  # noqa: E402
from repro.train.step import build_train_step as jax_build_train_step  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.core.flatten import TreeFlattener, tree_items  # noqa: E402
from repro_torch.launch.train import parse_args, run_config, train  # noqa: E402
from repro_torch.models import loss_and_aux, moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train.step import build_train_step, init_train_state  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

PAL = Parallel()
HERE = os.path.dirname(os.path.abspath(__file__))
# fp32 on both sides, summed in different orders: a few ulps
RTOL, ATOL = 1e-5, 1e-6
# the flat gradient's absolute bound: the token table's gradient (entries
# up to ~1.5) sums the rows of repeated tokens in another order than XLA
GRAD_ATOL = 4e-6
# logits and cache entries of magnitude ~1-5 (tests/test_torch_serve.py's)
SERVE_TOL = 1e-5
ARCH = "granite-moe-3b-a800m"
AUX = ("lb_loss", "z_loss", "drop_frac")


def _cfgs(arch=ARCH, **moe_fields):
    """(reference, port) reduced configs, the MoE fields replaced."""
    return [dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, **moe_fields)) for cfg in (
            jbase.reduced_config(jbase.get_config(arch)),
            tbase.reduced_config(tbase.get_config(arch)))]


def live(jparams, seed=0):
    """The reference's parameters (numpy) with every norm scale moved by
    N(0, 0.1^2) noise."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in ("scale", "kv_norm"):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(move, jax.device_get(jparams))


def lm_batch(batch=2, seq=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, (batch, seq)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((batch, 1), np.int32)],
                             1)
    return tokens, targets


def _reference_routing(logits, cfg):
    """The reference's routing lines of ``moe_fwd`` (tp = 1) on its own
    logits: top_p, top_e, slot, keep and the aux terms."""
    m = cfg.moe
    n, e = logits.shape
    probs = jax.nn.softmax(logits, -1)
    top_p, top_e = jax.lax.top_k(probs, m.top_k)
    top_p = top_p / jnp.maximum(jnp.sum(top_p, -1, keepdims=True), 1e-9)
    sel = jax.nn.one_hot(top_e, e, dtype=jnp.float32)
    cap = jmoe.capacity(n, e, m.top_k, m.capacity_factor)
    sel_flat = sel.reshape(n * m.top_k, e)
    pos_in_e = jnp.cumsum(sel_flat, 0) - sel_flat
    slot = jnp.sum(pos_in_e * sel_flat, -1).astype(jnp.int32)
    return top_p, top_e, slot, slot < cap


@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_routing_matches_reference_on_its_logits(factor):
    """Experts, slots and kept choices bitwise, the renormalised
    probabilities within RTOL, on the reference's logits of 96 tokens
    over 4 experts; at capacity factor 0.25 choices are dropped."""
    jcfg, tcfg = _cfgs(capacity_factor=factor)
    logits = np.random.default_rng(3).standard_normal((96, 4)).astype(
        np.float32)
    want = [np.asarray(t) for t in jax.jit(
        lambda x: _reference_routing(x, jcfg))(logits)]
    got = moe.route(torch.from_numpy(logits), tcfg)
    assert np.array_equal(got["top_e"].numpy(), want[1])
    assert np.array_equal(got["slot"].numpy(), want[2])
    assert np.array_equal(got["keep"].numpy(), want[3])
    np.testing.assert_allclose(got["top_p"].numpy(), want[0], rtol=RTOL)
    assert (float(got["drop_frac"]) > 0) == (factor < 1)


@pytest.mark.parametrize("arch,factor", [
    (ARCH, 1.25), (ARCH, 0.25), ("deepseek-v2-lite-16b", 1.25)],
    ids=["granite", "drops", "shared"])
def test_moe_fwd_matches_reference(arch, factor):
    """``moe_fwd`` on the same weights (the port's init carried across)
    and input (2, 20, 128): y and lb_loss, z_loss, drop_frac within RTOL
    / ATOL; at factor 0.25 some choices are dropped; deepseek's shared
    expert."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=factor)
    p = params_to_jax(moe.init_moe(torch.Generator().manual_seed(5), tcfg))
    x = np.random.default_rng(5).standard_normal((2, 20, 128)).astype(
        np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_fwd(p, x, jcfg, PAL))(p, x)
    y, aux = moe.moe_fwd(params_from_jax(p), torch.from_numpy(x), tcfg)
    assert ("shared" in p) == (arch != ARCH)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    for key in AUX:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    assert (float(aux["drop_frac"]) > 0) == (factor < 1)


def reference_init(tcfg, seed=0):
    """Parameters of ``tcfg`` drawn by the port's init from ``seed`` and
    carried into the reference's tree (numpy), norm scales moved: an
    eager draw, where the reference's init would be one more compile."""
    return live(params_to_jax(tfm.init_params(
        tcfg, torch.Generator().manual_seed(seed), "cpu")), seed)


def reference_grad(jcfg, jparams, batch=4, seq=32, stubs=None):
    """The batch and the jitted reference's loss, aux terms and gradient
    on it: shared by the loss test and the fused step's compressor.
    ``stubs``: a vision model's patches or an audio model's frames
    (numpy), whose batch they join; patch positions carry no loss, as
    the reference's ``lm_batch`` masks them."""
    tokens, targets = lm_batch(batch, seq)
    if stubs and "patches" in stubs:
        targets[:, :stubs["patches"].shape[1]] = -1
    jb = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets),
          **(stubs or {})}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jb, jcfg, PAL), has_aux=True))(jparams)
    return tokens, targets, jloss, jaux, jgrads


@pytest.fixture(scope="module")
def reference():
    """(reference config, port config, the reference's parameters, its
    reference_grad), computed once for the module."""
    jcfg, tcfg = _cfgs()
    jparams = reference_init(tcfg)
    return jcfg, tcfg, jparams, reference_grad(jcfg, jparams)


def torch_batch(tokens, targets=None, stubs=None) -> dict:
    """The port's batch of numpy tokens (and targets, and the patches or
    frames of ``stubs``)."""
    out = {"tokens": torch.from_numpy(tokens).long()}
    if targets is not None:
        out["targets"] = torch.from_numpy(targets).long()
    out.update({key: torch.from_numpy(np.array(val))
                for key, val in (stubs or {}).items()})
    return out


def check_loss_and_gradient(jcfg, tcfg, jparams, ref, stubs=None):
    """The flat J-vector bitwise, the loss and the aux terms within RTOL /
    ATOL, the flat gradient within RTOL / GRAD_ATOL of the jitted
    reference (``ref``: reference_grad's, of the same ``stubs``)."""
    tokens, targets, jloss, jaux, jgrads = ref
    jflat = JaxFlattener(jparams)
    tparams = params_from_jax(jparams)
    tflat = TreeFlattener(tparams)
    assert tflat.total == jflat.total == tcfg.param_count()
    assert np.array_equal(tflat.flatten(tparams).numpy(),
                          np.asarray(jflat.flatten(jparams)))
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_items(tparams)]
    loss, aux = loss_and_aux(tparams, torch_batch(tokens, targets, stubs),
                             tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    for key in AUX:
        np.testing.assert_allclose(float(aux[key].detach()), float(jaux[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(tflat.flatten(list(grads)).numpy(),
                               np.asarray(jflat.flatten(jgrads)), rtol=RTOL,
                               atol=GRAD_ATOL)


def test_loss_and_gradient_match_reference(reference):
    check_loss_and_gradient(*reference)


def check_prefill_and_decode(jcfg, tcfg, jparams, prompt=12, steps=3,
                             stubs=None):
    """Prefill logits and cache, then ``steps`` teacher-forced decode
    steps' logits, within SERVE_TOL of the reference's functions, from
    the port's prefill cache and from the reference's carried across
    (``convert.cache_from_jax``); the prompt's batch takes ``stubs``
    (numpy patches or frames of 2 rows). Returns the tokens and the
    port's logits, prefill's first."""
    from repro_torch.convert import cache_from_jax, cache_to_jax
    tparams = params_from_jax(jparams)
    tokens = np.random.default_rng(1).integers(0, 512, (2, prompt + steps))
    max_seq = prompt + steps
    jlogits, jcache = jax.jit(lambda p, t, st: jax_prefill(
        p, {"tokens": t, **st}, jcfg, PAL, max_seq=max_seq))(
            jparams, jnp.asarray(tokens[:, :prompt], np.int32), stubs or {})
    with torch.inference_mode():
        logits, cache = tfm.prefill(
            tparams, torch_batch(tokens[:, :prompt], stubs=stubs), tcfg,
            max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=SERVE_TOL, atol=SERVE_TOL)
    jitems = tree_items(jax.device_get(jcache))
    titems = tree_items(cache_to_jax(cache))
    assert [p for p, _ in titems] == [p for p, _ in jitems]
    for (path, got), (_, want) in zip(titems, jitems):
        np.testing.assert_allclose(got, want, rtol=SERVE_TOL,
                                   atol=SERVE_TOL, err_msg=str(path))
    carried = cache_from_jax(jax.device_get(jcache))
    jdec = jax.jit(lambda p, c, t: jax_decode_step(p, c, t, jcfg, PAL))
    want = []
    for i in range(prompt, prompt + steps):
        jlogits, jcache = jdec(jparams, jcache,
                               jnp.asarray(tokens[:, i:i + 1], np.int32))
        want.append(np.asarray(jlogits))
    # the port's cache, then the reference's carried across
    got = [logits]
    for start, kept in ((cache, got), (carried, [])):
        for i, jl in zip(range(prompt, prompt + steps), want):
            with torch.inference_mode():
                logits, start = tfm.decode_step(
                    tparams, start, torch.from_numpy(tokens[:, i:i + 1]),
                    tcfg)
            np.testing.assert_allclose(logits.numpy(), jl, rtol=SERVE_TOL,
                                       atol=SERVE_TOL, err_msg=f"step {i}")
            kept.append(logits)
    return tokens, got


def test_prefill_and_decode_match_reference(reference):
    check_prefill_and_decode(*reference[:3])


def check_fused_step(jcfg, tcfg, jparams, ref, stubs=None,
                     exact_zeros=True):
    """The main path (REGTOP-k, fused, sparse comm): the compressor on
    the reference's own flat gradient bitwise (values, indices, every
    state vector); one train step of each package on the same weights
    and batch (``ref``'s, with ``stubs``) with the same loss and aux
    metrics within RTOL, the same support (``idx_prev``), zero error at
    the support, the error within RTOL / GRAD_ATOL of the reference's
    and, with ``exact_zeros``, the same zeroed error entries (a model
    whose gradient has entries that are zero in exact arithmetic but
    rounding noise in fp32 passes False)."""
    from repro.optim import init_opt_state as jax_init_opt_state
    kw = dict(kind="regtopk", sparsity=0.01, mu=0.5, pipeline="fused",
              comm_mode="sparse")
    jrun, trun = [mod.RunConfig(
        model=cfg, shape=mod.SHAPES["train_4k"],
        sparsifier=mod.SparsifierConfig(**kw),
        optimizer=mod.OptimizerConfig(kind="adam", lr=1e-3), seed=0,
        steps=1) for mod, cfg in ((jbase, jcfg), (tbase, tcfg))]
    tokens, targets, _, _, jgrads = ref
    jflat = JaxFlattener(jparams)
    g = np.asarray(jflat.flatten(jgrads))

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
        assert np.array_equal(
            want.view(np.int32) if want.dtype != np.int32 else want,
            tout.state[key].numpy().view(np.int32)), key

    # the reference's one-device train state: (1, 1, ...) slices
    def rows(tree):
        return jax.tree_util.tree_map(
            lambda l: l.reshape((1, 1) + l.shape) if l.ndim else l, tree)
    mesh = make_mesh(1, 1)
    pal = build_parallel(mesh)
    jb = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets),
          **(stubs or {})}
    with mesh:
        step_fn, _, _ = jax_build_train_step(jrun, mesh, pal)
        _, _, ef, metrics = jax.jit(step_fn)(
            jax.tree_util.tree_map(jnp.asarray, jparams),
            rows(jax_init_opt_state(jrun.optimizer, jflat.flatten(jparams))),
            rows(jsp.init_state(jrun.sparsifier, jflat.total)), jb,
            jax.random.PRNGKey(0))
    tstate = init_train_state(trun, "cpu", params=params_from_jax(jparams))
    tstate, tmetrics = build_train_step(trun, "cpu")(
        tstate, torch_batch(tokens, targets, stubs))
    for key in ("loss",) + AUX:
        np.testing.assert_allclose(float(tmetrics[key]), float(metrics[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    want = np.sort(np.asarray(ef["idx_prev"]).reshape(-1))
    got = np.sort(tstate.ef["idx_prev"].numpy().view(np.uint32))
    assert np.array_equal(want, got)
    err, jerr = tstate.ef["err_prev"].numpy(), np.asarray(
        ef["err_prev"]).reshape(-1)
    assert not err[got.view(np.int32)].any()
    np.testing.assert_allclose(err, jerr, rtol=RTOL, atol=GRAD_ATOL)
    if exact_zeros:
        assert np.array_equal(jerr == 0, err == 0)


def test_fused_step_matches_reference(reference):
    check_fused_step(*reference)


def check_train_launcher(arch):
    """``--arch`` takes the config; the main path trains the smoke model,
    the loss falling on a fixed batch, each step recording the aux
    terms."""
    run = run_config(parse_args(["--arch", arch, "--smoke", "--steps", "4",
                                 "--comm", "sparse", "--pipeline", "fused"]))
    assert run.model.name == f"{arch}-smoke"
    out = train(run, device="cpu", batch=2, seq=16, fixed_batch=True,
                log=lambda msg: None)
    losses = [rec["loss"] for rec in out["history"]]
    assert out["params"] == run.model.param_count()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for rec in out["history"]:
        assert all(np.isfinite(rec[key]) for key in AUX), rec


def test_train_launcher_takes_granite_moe():
    check_train_launcher(ARCH)


def test_aux_metrics_are_group_means_at_world_2(tmp_path):
    """Over a gloo group of 2 the step's loss and aux metrics are the
    means of the two ranks' own values (each rank's rows of the global
    batch through ``loss_and_aux`` on the same parameters): the
    reference's ``pmean`` over the data axes."""
    cfg = tbase.reduced_config(tbase.get_config(ARCH))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = TreeFlattener(params).flatten(params).numpy()
    tokens, targets = lm_batch(4, 16, seed=7)
    inp = tmp_path / "in.npz"
    np.savez(inp, arch=ARCH, steps=1, tokens=tokens, targets=targets,
             init_params=flat, cases=json.dumps({"main": dict(sparsifier=dict(
                 kind="regtopk", sparsity=0.01, mu=0.5, pipeline="fused",
                 comm_mode="sparse"))}))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"),
         "world_train", str(r), "2", str(tmp_path / "rendezvous"), str(inp),
         str(tmp_path / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    own = []
    with torch.no_grad():
        for r in range(2):
            loss, aux = loss_and_aux(params, {
                "tokens": torch.from_numpy(tokens[2 * r:2 * r + 2]).long(),
                "targets": torch.from_numpy(targets[2 * r:2 * r + 2]).long()},
                cfg)
            own.append(dict(aux, loss=loss))
    for key in ("loss",) + AUX:
        want = (float(own[0][key]) + float(own[1][key])) * 0.5
        for out in outs:
            np.testing.assert_allclose(float(out[f"main_{key}_0"]), want,
                                       rtol=RTOL, atol=ATOL, err_msg=key)
    assert float(outs[0]["main_drop_frac_0"]) > 0     # factor 1.25 drops
