"""The port's threefry draws and fault schedules against jax and the
reference's ``repro.core.faults``, bit for bit: the threefry words,
fold_in, the 0-d random bits and uniform draw, and the participation
matrices of every schedule kind (the reference's side evaluated under
``jax.jit`` over all (step, worker) pairs at once)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro_torch.core import faults, threefry  # noqa: E402

STEPS, WORKERS = 24, 4


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


def test_partitionable_layout_is_the_environments():
    """The port implements the partitionable layout; a change of jax's
    default shows here, not as a silent mismatch below."""
    assert jax.config.jax_threefry_partitionable is True


def test_threefry_words_match_jax():
    rng = np.random.default_rng(0)
    k0, k1, x0, x1 = (rng.integers(0, 2 ** 32, 64, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    want = jax.jit(jprng.threefry2x32_p.bind)(*(jnp.asarray(v) for v in
                                               (k0, k1, x0, x1)))
    got = threefry.threefry2x32(*(torch.from_numpy(v.astype(np.int64))
                                  for v in (k0, k1, x0, x1)))
    for w, g in zip(want, got):
        assert np.array_equal(_u32(w), g.numpy().astype(np.uint32))


@pytest.mark.parametrize("seed,data", [(0, (3, 1)), (7, (0, 2)),
                                       (2 ** 31 - 1, (123456, 0)),
                                       (5, (2 ** 31 - 1, 3))])
def test_fold_in_bits_and_uniform_match_jax(seed, data):
    jkey, tkey = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    assert np.array_equal(_u32(jkey), tkey.numpy().astype(np.uint32))
    for d in data:
        jkey = jax.random.fold_in(jkey, d)
        tkey = threefry.fold_in(tkey, torch.tensor(d, dtype=torch.int32))
        assert np.array_equal(_u32(jkey), tkey.numpy().astype(np.uint32))
    assert int(jax.random.bits(jkey)) == int(threefry.random_bits32(tkey))
    want = np.float32(jax.random.uniform(jkey))
    got = threefry.uniform01(tkey)
    assert got.dtype == torch.float32 and got.shape == ()
    assert want.view(np.int32) == got.numpy().view(np.int32)


def test_a_known_draw():
    """fold_in(fold_in(PRNGKey(0), 3), 1): key words, bits and uniform."""
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(0), 3), 1)
    assert key.tolist() == [2060067018, 3241019684]
    assert int(threefry.random_bits32(key)) == 3646506523
    assert float(threefry.uniform01(key)) == float(np.float32(0.84901845))


def _jax_matrix(sched) -> np.ndarray:
    steps = jnp.arange(STEPS, dtype=jnp.int32)
    workers = jnp.arange(WORKERS, dtype=jnp.int32)
    f = jax.jit(jax.vmap(jax.vmap(
        lambda t, w: jfaults.participates(sched, t, w),
        in_axes=(None, 0)), in_axes=(0, None)))
    return np.asarray(f(steps, workers))


SPECS = ([f"iid:{p},seed={s}" for p in (0.1, 0.3, 0.7) for s in (0, 1, 9)]
         + ["bursty:period=3,outage=1,workers=0",
            "bursty:period=5,outage=2,workers=1+3",
            "permanent:step=4,workers=2", "permanent:step=0"])


@pytest.mark.parametrize("spec", SPECS)
def test_participation_matrix_matches_reference(spec):
    sched = faults.parse_schedule(spec)
    jsched = jfaults.parse_schedule(spec)
    assert faults.format_schedule(sched) == jfaults.format_schedule(jsched)
    assert faults.parse_schedule(faults.format_schedule(sched)) == sched
    got = faults.participation_matrix(sched, STEPS, WORKERS)
    assert got.dtype == bool and got.shape == (STEPS, WORKERS)
    assert np.array_equal(got, _jax_matrix(jsched))
    assert faults.describe(sched, WORKERS) == jfaults.describe(jsched,
                                                               WORKERS)
    if sched.kind == "iid":
        assert 0 < got.sum() < got.size


def test_participates_stays_on_the_step_device():
    sched = faults.parse_schedule("iid:0.5,seed=3")
    step = torch.tensor(6, dtype=torch.int32)
    bit = faults.participates(sched, step, 2)
    assert bit.dtype == torch.bool and bit.shape == ()
    assert bit.device == step.device
    assert bool(faults.participates(None, step, 0))


@pytest.mark.parametrize("spec", ["", "none", "iid:0.25",
                                  "bursty:period=4,outage=4,workers=0+2"])
def test_parse_and_expected_active_match_reference(spec):
    sched, jsched = faults.parse_schedule(spec), jfaults.parse_schedule(spec)
    assert (sched is None) == (jsched is None)
    if sched is not None:
        assert sched.__dict__ == jsched.__dict__
    assert faults.expected_active(sched, 4) == jfaults.expected_active(
        jsched, 4)


@pytest.mark.parametrize("bad", ["gauss:0.1", "iid:1.5",
                                 "bursty:period=0,outage=1", "iid:0.1,x"])
def test_bad_specs_raise_like_the_reference(bad):
    with pytest.raises(ValueError):
        jfaults.parse_schedule(bad)
    with pytest.raises(ValueError):
        faults.parse_schedule(bad)
