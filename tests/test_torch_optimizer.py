"""The port's optimizers (``repro_torch.optim``) against the reference's
``repro.optim`` compiled with ``jax.jit``: sgd, momentum, adam and adamw,
at a constant rate and with warmup and a cosine decay, with and without
global-norm clipping, 5 steps on one slice.

The compiled reference contracts each multiply feeding an add into a
fused multiply-add; the port's sgd and momentum do the same
(``numerics.fma_f32``), so at a constant rate they are bitwise. The
cosine schedule goes through ``cos`` and Adam through fp32 ``pow``,
which torch and XLA may round an ulp apart, and the port's Adam rounds
its moments' multiply-adds twice: those agree to the tolerances below."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.optim import apply_updates as jax_apply  # noqa: E402
from repro.optim import init_opt_state as jax_init  # noqa: E402
from repro.optim import lr_at_step as jax_lr  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.optim import apply_updates, init_opt_state, lr_at_step  # noqa: E402

N = 1000
STEPS = 5
# lr: ``cos`` of torch and of XLA may differ by an ulp, so 2 ulp relative
LR_RTOL = 2.0 ** -22
# state: Adam's moments differ from the compiled program by the rounding
# of one multiply-add a step, about 2^-24 of its terms' size (an entry
# whose terms cancel can differ by far more than 2^-24 of itself), so
# the bound is relative to the vector's largest entry: 1e-6 of it
# leaves margin over five steps and still catches a wrong factor
STATE_RTOL = 1e-6
# master: each step moves a coordinate by at most ~lr (Adam normalises
# the update), so errors of 1e-5 relative in the update move it by
# 1e-5 * lr a step at most
MASTER_ATOL = 1e-5 * 1e-2 * STEPS

SCHEDULES = {"constant": dict(),
             "warmup_cosine": dict(warmup_steps=2, schedule="cosine",
                                   total_steps=6)}


def _cfgs(**kw):
    kw = dict(dict(lr=1e-2), **kw)
    return jbase.OptimizerConfig(**kw), tbase.OptimizerConfig(**kw)


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_lr_at_step_matches_reference(schedule):
    jcfg, tcfg = _cfgs(**SCHEDULES[schedule])
    jlr = jax.jit(lambda s: jax_lr(jcfg, s))
    for t in range(8):
        want = np.asarray(jlr(jnp.int32(t)))
        got = lr_at_step(tcfg, torch.tensor(t, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32
        if schedule == "constant":
            assert _bits(want) == _bits(got), t
        else:
            np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0)


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam", "adamw"])
def test_apply_updates_matches_reference(kind, schedule, clip):
    """5 steps from the same master and gradients. With ``grad_clip``
    both sides get the same global norm in ``state["gnorm"]``, as the
    train steps pass it (the gradients' norm is ~30, so the clip acts)."""
    jcfg, tcfg = _cfgs(kind=kind, grad_clip=clip, weight_decay=0.1,
                       **SCHEDULES[schedule])
    rng = np.random.default_rng(["sgd", "momentum", "adam",
                                 "adamw"].index(kind))
    master = rng.standard_normal(N).astype(np.float32)
    jst = jax_init(jcfg, jnp.asarray(master))
    tst = init_opt_state(tcfg, torch.from_numpy(master.copy()))
    assert set(tst) == set(jst)
    jstep = jax.jit(lambda st, g: jax_apply(jcfg, st, g))
    exact = kind in ("sgd", "momentum") and schedule == "constant"
    for t in range(STEPS):
        g = rng.standard_normal(N).astype(np.float32)
        if clip:
            gn = np.float32(np.linalg.norm(g.astype(np.float64)))
            jst = dict(jst, gnorm=jnp.asarray(gn))
            tst = dict(tst, gnorm=torch.tensor(gn))
        jm, jst = jstep(jst, jnp.asarray(g))
        tm, tst = apply_updates(tcfg, tst, torch.from_numpy(g))
        assert set(tst) == set(jst) and "gnorm" not in tst, t
        assert int(tst["step"]) == int(jst["step"]) == t + 1
        assert torch.equal(tm, tst["master"])
        for key in set(jst) - {"step"}:
            want, got = np.asarray(jst[key]), tst[key].numpy()
            if exact:
                assert np.array_equal(_bits(want), _bits(got)), (t, key)
            elif key == "master":
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=MASTER_ATOL)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=STATE_RTOL * float(np.abs(want).max()))


def test_slice_norm_when_no_global_norm_is_given():
    """Without ``state["gnorm"]`` the clip uses the slice's own norm, as
    the reference's does."""
    jcfg, tcfg = _cfgs(kind="sgd", grad_clip=1.0)
    rng = np.random.default_rng(7)
    master, g = (rng.standard_normal(N).astype(np.float32)
                 for _ in range(2))
    want, _ = jax.jit(lambda st, g: jax_apply(jcfg, st, g))(
        jax_init(jcfg, jnp.asarray(master)), jnp.asarray(g))
    got, _ = apply_updates(tcfg, init_opt_state(
        tcfg, torch.from_numpy(master)), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    moved = np.abs(got.numpy() - master)
    assert np.sqrt((moved.astype(np.float64) ** 2).sum()) == \
        pytest.approx(1e-2, rel=1e-5)       # lr * the clipped norm 1


# a slice as long as a tensor-parallel rank's J_local of reduced Jamba on
# a (2, 2) grid: torch.linalg.vector_norm's fp32 CPU reduction drifted 4e-5
# relative there, XLA's windowed sum does not
N_LONG = 881_920


def test_slice_norm_of_a_long_slice():
    """The clip's own norm of a long slice (and the train step's
    ``gnorm_local``, ``numerics.norm_f32``) is the compiled reference's
    ``jnp.linalg.norm`` to 1e-7: sgd at lr 1 from zeros moves by the
    clipped gradient, g / |g|."""
    from repro_torch.core.numerics import norm_f32
    jcfg, tcfg = (dataclasses.replace(c, lr=1.0) for c in _cfgs(
        kind="sgd", grad_clip=1.0))
    g = np.random.default_rng(8).standard_normal(N_LONG).astype(np.float32)
    g = g * np.random.default_rng(9).random(N_LONG).astype(np.float32) ** 4
    master = np.zeros(N_LONG, np.float32)
    want, _ = jax.jit(lambda st, g: jax_apply(jcfg, st, g))(
        jax_init(jcfg, jnp.asarray(master)), jnp.asarray(g))
    got, _ = apply_updates(tcfg, init_opt_state(
        tcfg, torch.from_numpy(master)), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                               atol=0)
    norm = float(jax.jit(jnp.linalg.norm)(g))
    assert abs(float(norm_f32(torch.from_numpy(g))) - norm) <= 1e-7 * norm


def test_default_optimizer_is_sgd_in_both_packages():
    for mod in (jbase, tbase):
        run = mod.RunConfig(mod.get_config("stablelm-3b"),
                            mod.SHAPES["train_4k"])
        assert run.optimizer.kind == "sgd"
        assert run.optimizer == mod.OptimizerConfig()
    theirs = jbase.OptimizerConfig()
    ours = tbase.OptimizerConfig()
    for field in theirs.__dataclass_fields__:
        assert getattr(ours, field) == getattr(theirs, field), field
    assert tbase.SparsifierConfig().momentum == \
        jbase.SparsifierConfig().momentum == 0.9
