"""The port's xLSTM mixers and reduced xLSTM-125M against the reference on
the same weights: ``mlstm_fwd`` and ``slstm_fwd`` (the output and the
final state), one ``mlstm_decode`` / ``slstm_decode`` step from a
reference state, the loss and flat gradient (the flat J-vector bit for
bit) with the reduced config's dense GELU FFN and with none (the full
config's ``ffn="none"`` layers, no ``norm2``), prefill logits and every
cache leaf, then 3 decode steps from the port's cache and from the
reference's carried across, one REGTOP-k fused sparse train step through
both train steps (the compressor bitwise on the reference's own
gradient), the train launcher, and that the model adds no sinusoidal
positions.

The weights are drawn by the port's init and carried into the
reference's tree, every norm scale and bias and the mixers' ``ln_h``
moved off their init values by numpy noise from a seed.

Tolerances: test_torch_moe.py's RTOL 1e-5, ATOL 1e-6 and GRAD_ATOL 4e-6,
SERVE_TOL 1e-5 for the serving path, and SCAN_ATOL for a mixer's output
(below). The scans are sequential in both packages and their states
agree to an ulp or two."""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_moe import (  # noqa: E402
    ATOL, PAL, RTOL, check_fused_step, check_loss_and_gradient,
    check_prefill_and_decode, reference_grad)
from torch_threads import one_thread  # noqa: E402,F401

from repro.configs import base as jbase  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    parse_args, run_config, train)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.models.layers import embed_fwd  # noqa: E402

ARCH = "xlstm-125m"
# a mixer's output, absolute: the mLSTM's readout C q sums hd products
# in another order than XLA's dot (on the scan's own inputs, state c
# within 1 ulp, the readout 2.4e-6 off on entries up to 7.6), and the
# down projection sums heads of up to ~2.5 into entries near 0: the worst
# seen is 1.5e-6 on an entry of 8e-3 (40 steps, the reduced widths)
SCAN_ATOL = 4e-6
# leaves at a constant init value, moved so that a wrong use shows
MOVED = ("scale", "bias", "kv_norm", "ln_h", "D", "conv_b")


def cfgs(arch=ARCH, **fields):
    """(reference, port) reduced configs, ``fields`` replaced."""
    return [dataclasses.replace(mod.reduced_config(mod.get_config(arch)),
                                **fields) for mod in (jbase, tbase)]


def live(tree, seed=0):
    """A numpy tree (the reference's layout) with every leaf named in
    MOVED moved by N(0, 0.1^2) noise."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in MOVED:
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(move, tree)


def reference_init(tcfg, seed=0):
    """The port's init of ``tcfg`` from ``seed``, carried into the
    reference's tree, MOVED leaves moved."""
    return live(params_to_jax(tfm.init_params(
        tcfg, torch.Generator().manual_seed(seed), "cpu")), seed)


def close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


MIXERS = {"mlstm": (txl.init_mlstm, txl.mlstm_fwd, txl.init_mlstm_cache,
                    txl.mlstm_decode, jxl.mlstm_fwd, jxl.mlstm_decode),
          "slstm": (txl.init_slstm, txl.slstm_fwd, txl.init_slstm_cache,
                    txl.slstm_decode, jxl.slstm_fwd, jxl.slstm_decode)}


def _mixer_case(name, seq=40):
    """The mixer's parameters (numpy, moved), an input (2, seq, 128) and
    the jitted reference's output and final state."""
    jcfg, tcfg = cfgs()
    init = MIXERS[name][0]
    p = live(params_to_jax(init(torch.Generator().manual_seed(1), tcfg)), 1)
    x = np.random.default_rng(2).standard_normal((2, seq, 128)).astype(
        np.float32)
    jy, jst = jax.jit(lambda p, x: MIXERS[name][4](
        p, x, jcfg, PAL, return_state=True))(p, x)
    return jcfg, tcfg, p, x, jy, jax.device_get(jst)


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_mixer_matches_reference(name):
    """The output within RTOL / SCAN_ATOL, and the final state {c, n,
    m} written into a decode cache within RTOL / ATOL, over a 40-step
    scan."""
    _, tcfg, p, x, jy, jst = _mixer_case(name)
    _, fwd, init_cache, *_ = MIXERS[name]
    cache = init_cache(tcfg, 2)
    with torch.no_grad():
        y = fwd(params_from_jax(p), torch.from_numpy(x), tcfg, cache)
    close(y, jy, "y", atol=SCAN_ATOL)
    assert sorted(cache) == sorted(jst)
    for key, want in jst.items():
        close(cache[key], want, key)


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_mixer_decode_matches_reference(name):
    """One decode step from the reference's state after 40 steps: the
    output and the new state (written in place) within RTOL / ATOL."""
    jcfg, tcfg, p, _, _, jst = _mixer_case(name)
    *_, decode, _, jdecode = MIXERS[name]
    x1 = np.random.default_rng(3).standard_normal((2, 1, 128)).astype(
        np.float32)
    jy, jnew = jax.jit(lambda p, x, c: jdecode(p, x, c, jcfg, PAL))(
        p, x1, jst)
    cache = {key: torch.from_numpy(np.array(val)) for key, val in jst.items()}
    with torch.no_grad():
        y = decode(params_from_jax(p), torch.from_numpy(x1), cache, tcfg)
    close(y, jy, "y")
    for key, want in jax.device_get(jnew).items():
        close(cache[key], want, key)


@pytest.fixture(scope="module", params=["ffn", "no_ffn"])
def reference(request):
    """Reduced xLSTM as ``reduced_config`` gives it (d_ff 256: a dense
    GELU FFN after each mixer) and with d_ff 0 (the full config's layer:
    no FFN, no norm2): configs, the reference's parameters and its
    reference_grad."""
    fields = {} if request.param == "ffn" else {"d_ff": 0}
    jcfg, tcfg = cfgs(**fields)
    jparams = reference_init(tcfg)
    return jcfg, tcfg, jparams, reference_grad(jcfg, jparams)


def test_loss_and_gradient_match_reference(reference):
    jcfg, tcfg, jparams, _ = reference
    layer = jparams["blocks"]["l0"]
    assert ("norm2" in layer) == (tcfg.d_ff > 0)
    assert "norm1" not in layer and "norm" in layer["mlstm"]
    check_loss_and_gradient(*reference)


def test_prefill_and_decode_match_reference(reference):
    check_prefill_and_decode(*reference[:3])


def test_fused_step_matches_reference(reference):
    check_fused_step(*reference)


def test_no_positions_with_an_ssm():
    """An SSM model's embedding is the token rows alone, in the batch and
    in decode (the reference's ``not cfg.rope and cfg.ssm is None``);
    the same config without its SSM would add sinusoidal positions."""
    for arch in (ARCH, "jamba-v0.1-52b"):
        cfg = cfgs(arch)[1]
        assert not cfg.rope and cfg.ssm is not None
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        tokens = torch.arange(10).reshape(2, 5)
        rows = embed_fwd(params["embed"], tokens, cfg)
        assert torch.equal(tfm.embed_batch(params, tokens, cfg), rows)
        pos = torch.tensor(7, dtype=torch.int32)
        assert torch.equal(tfm.embed_batch(params, tokens[:, :1], cfg, pos),
                           rows[:, :1])
        dense = dataclasses.replace(cfg, ssm=None, attn_every=1)
        assert not torch.equal(tfm.embed_batch(params, tokens, dense), rows)


def test_train_launcher_takes_xlstm():
    """``--arch xlstm-125m --smoke`` trains the reduced model on the main
    path: 2 steps, the loss finite, J the config's count."""
    run = run_config(parse_args(["--arch", ARCH, "--smoke", "--steps", "2",
                                 "--comm", "sparse", "--pipeline", "fused"]))
    assert run.model.name == f"{ARCH}-smoke"
    out = train(run, device="cpu", batch=2, seq=16, fixed_batch=True,
                log=lambda msg: None)
    assert out["params"] == run.model.param_count()
    losses = [rec["loss"] for rec in out["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses


def test_the_full_config_counts_the_references_parameters():
    """xLSTM-125M at full width and depth: 12 layers of mLSTM and sLSTM
    without an FFN, J = 164,669,952, the reference's count; the meta
    device's init holds that many elements."""
    from repro_torch.core.flatten import tree_size
    cfg = tbase.get_config(ARCH)
    assert cfg.param_count() == jbase.get_config(ARCH).param_count() \
        == 164_669_952
    tfm.check_model(cfg)
    assert tfm.layer_pattern(cfg) == [("mlstm", "none"), ("slstm", "none")]
    assert tree_size(tfm.init_params(cfg, torch.Generator(), "meta")) == \
        164_669_952
