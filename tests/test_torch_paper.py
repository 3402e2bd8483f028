"""The paper experiments' parts on the port against the reference: the
synthetic data (array for array), the stand-in CNN on carried-across
weights (logits, loss, the flat gradient, the flat order, XLA's
asymmetric "SAME" padding), and the figure drivers' trajectories (fig1,
fig2 at S = 0.6, a short fig3 at width 4).

Tolerances, and why:

- CNN logits, loss and gradient: rtol 1e-5, atol 1e-6. The convolutions
  and the normalisation's means sum in other orders than XLA's; the
  gradients differ by at most ~2e-7 at widths 4 and 16 on these inputs.
- fig1: rtol 1e-5, atol 1e-6. The reference driver runs its rounds
  eagerly (no fused multiply-adds, a true division by mu), the port
  follows the compiled program; the losses differ in the last bits.
- fig2: rtol 1e-5 on the gap ||w - w*||. The workers' gradients are
  matrix products that both packages sum in their own orders (~1e-7
  relative), and the selection is the same at every step of the 200.
- fig3: the test accuracies equal. The drivers select from the same
  gradients up to ~1e-7, so the same k coordinates move.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.flatten_util import ravel_pytree  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro.data import synthetic as jdata  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import (cnn_params_from_jax, cnn_params_to_jax,  # noqa: E402
                                 ravel_cnn, unravel_cnn)
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """The drivers run thousands of rounds on vectors of 100 entries, which
    more threads do not speed up: one thread keeps this file from
    crowding the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_linreg_dataset_equals_reference(seed):
    want = jdata.linreg_dataset(6, 50, 10, seed=seed)
    got = tdata.linreg_dataset(6, 50, 10, seed=seed, device="cpu")
    for ws, gs in zip(want[:2], got[:2]):
        assert len(ws) == len(gs) == 6
        for w, g in zip(ws, gs):
            assert g.dtype == torch.float32
            assert np.array_equal(_np(w), _np(g))
    assert got[2].dtype == torch.float32
    assert np.array_equal(_np(want[2]), _np(got[2]))


def test_image_dataset_equals_reference():
    want = jdata.image_dataset(n_train=64, n_test=32, seed=1)
    got = tdata.image_dataset(n_train=64, n_test=32, seed=1, device="cpu")
    for w, g in zip(want, got):
        assert np.array_equal(_np(w), _np(g))
    assert got[0].shape == (64, 16, 16, 3) and got[0].dtype == torch.float32
    assert got[1].dtype == torch.int64


def test_data_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (tdata.linreg_dataset, tdata.image_dataset):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# ---------------------------------------------------------------------------
# the CNN
# ---------------------------------------------------------------------------

def _batch(n=20, seed=0):
    x, y, _, _ = jdata.image_dataset(n_train=n, n_test=1, seed=seed)
    return np.array(x), np.array(y)


@pytest.mark.parametrize("width", [4, 16])
def test_cnn_matches_reference(width):
    """Logits, loss and the flat gradient on the reference's weights,
    carried across; the flat vector in the reference's ravel order."""
    p = jcnn.init_cnn(jax.random.PRNGKey(width), width=width)
    tp = cnn_params_from_jax(jax.device_get(p))
    assert tp["stem"].shape == (width, 3, 3, 3)           # OIHW
    x, y = _batch(seed=width)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(_np(tcnn.cnn_fwd(tp, tx)),
                               np.asarray(jax.jit(jcnn.cnn_fwd)(p, x)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tcnn.cnn_loss(tp, tx, ty)),
                               float(jax.jit(jcnn.cnn_loss)(p, x, y)),
                               rtol=RTOL)
    jflat, _ = ravel_pytree(p)
    assert np.array_equal(np.asarray(jflat), _np(ravel_cnn(tp)))
    jg, _ = ravel_pytree(jax.jit(jax.grad(jcnn.cnn_loss))(p, x, y))
    tg = ravel_cnn(tcnn.cnn_grad(tp, tx, ty))
    assert tg.numel() == jflat.size == (5046 if width == 4 else 77370)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)
    back = cnn_params_to_jax(unravel_cnn(ravel_cnn(tp), tp))
    for key, val in p.items():
        assert np.array_equal(back[key], np.asarray(val)), key


def test_flat_index_names_the_same_weight():
    """Perturbing flat index i in each package moves the same weight: the
    reference's unravelled tree and the port's, converted back, differ
    from the originals at the same leaf and position."""
    p = jcnn.init_cnn(jax.random.PRNGKey(1), width=4)
    flat, unravel = ravel_pytree(p)
    tp = cnn_params_from_jax(jax.device_get(p))
    tflat = ravel_cnn(tp)
    rng = np.random.default_rng(0)
    for i in rng.choice(flat.size, 40, replace=False):
        want = jax.device_get(unravel(flat.at[i].add(1.0)))
        bumped = tflat.clone()
        bumped[i] += 1.0
        got = cnn_params_to_jax(unravel_cnn(bumped, tp))
        for key in p:
            moved_w = np.argwhere(want[key] != np.asarray(p[key]))
            moved_g = np.argwhere(got[key] != np.asarray(p[key]))
            assert np.array_equal(moved_w, moved_g), (i, key)


def test_stride2_same_padding_is_asymmetric():
    """XLA's "SAME" at stride 2 from 16 to 8 pads 0 before and 1 after:
    the port's convolution equals the reference's, and a symmetric
    padding of 1 shifts every output."""
    import torch.nn.functional as F
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: jcnn._conv(a, b, 2))(x, w))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    got = _np(tcnn._same(tx, tw, 2).permute(0, 2, 3, 1))
    assert got.shape == want.shape == (2, 8, 8, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    sym = _np(F.conv2d(tx, tw, stride=2, padding=1).permute(0, 2, 3, 1))
    assert sym.shape == want.shape
    assert not np.allclose(sym, want, rtol=1e-2, atol=1e-2)


def test_cnn_convolves_in_fp32_and_restores_the_flag(monkeypatch):
    prev = torch.backends.cudnn.allow_tf32
    with tcnn.fp32_convolutions():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == prev
    # cnn_fwd called directly, by a caller that allows TF32: every
    # convolution still runs with it off, and the caller's flag stands
    F = tcnn.F
    seen, conv2d = [], F.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    p = tcnn.init_cnn(torch.Generator().manual_seed(0), width=4)
    tcnn.cnn_fwd(p, torch.zeros(2, 16, 16, 3))
    assert seen == [False] * len(tcnn._CONVS)
    assert torch.backends.cudnn.allow_tf32 is True


# ---------------------------------------------------------------------------
# the figure drivers
# ---------------------------------------------------------------------------

def test_fig1_trajectories_match_reference():
    from benchmarks.paper_experiments import fig1_toy_logistic as ref
    from repro_torch.paper_experiments import fig1_toy_logistic
    want, got = ref(iters=100), fig1_toy_logistic(iters=100, device="cpu")
    assert set(got) == set(want) == {"none", "topk", "regtopk"}
    for kind in want:
        assert len(got[kind]) == 100
        np.testing.assert_allclose(got[kind], want[kind], rtol=RTOL,
                                   atol=ATOL, err_msg=kind)


def test_fig2_trajectories_match_reference():
    from benchmarks.paper_experiments import fig2_linreg as ref
    from repro_torch.paper_experiments import fig2_linreg
    kinds = ("none", "topk", "regtopk", "sketchtopk", "globaltopk")
    want = ref(S_values=(0.6,), iters=200, kinds=kinds)
    got = fig2_linreg(S_values=(0.6,), iters=200, kinds=kinds, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert len(got[key]) == 200
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   err_msg=str(key))


def test_fig3_short_run_matches_reference(monkeypatch):
    """Five iterations at width 4 from the reference's initial weights,
    carried across: the same test accuracies for topk and regtopk, and
    the parameters each package evaluates (caught at its accuracy call)
    within the CNN's tolerance, so both moved the same coordinates."""
    from benchmarks.paper_experiments import fig3_nn as ref
    from repro_torch.paper_experiments import fig3_nn
    seen = {"jax": [], "torch": []}

    def spy(side, fn):
        def acc(p, x, y, *a, **k):
            seen[side].append(p)
            return fn(p, x, y, *a, **k)
        return acc

    monkeypatch.setattr(jcnn, "cnn_accuracy", spy("jax", jcnn.cnn_accuracy))
    monkeypatch.setattr(tcnn, "cnn_accuracy",
                        spy("torch", tcnn.cnn_accuracy))
    kw = dict(iters=5, eval_every=5, width=4, kinds=("topk", "regtopk"))
    want = ref(**kw)
    p0 = jcnn.init_cnn(jax.random.PRNGKey(0), width=4)
    got = fig3_nn(**kw, device="cpu",
                  params=cnn_params_from_jax(jax.device_get(p0)))
    assert got == want
    assert len(seen["jax"]) == len(seen["torch"]) == 2
    for jp, tp in zip(seen["jax"], seen["torch"]):
        jflat, _ = ravel_pytree(jp)
        np.testing.assert_allclose(_np(ravel_cnn(tp)), np.asarray(jflat),
                                   rtol=RTOL, atol=ATOL)


def test_drivers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import paper_experiments as pe
    for call in (lambda: pe.fig1_toy_logistic(iters=1),
                 lambda: pe.fig2_linreg(iters=1),
                 lambda: pe.fig3_nn(iters=1), lambda: pe.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
