"""The port's vision family (reduced Phi-3-vision: the phi3-mini decoder,
rmsnorm, SwiGLU, RoPE, with the CLIP patch stub over its first 16
positions) against the reference on the same weights: the patch
overwrite of the embedded batch bit for bit; the synthetic batch's
masked patch positions; the loss and flat gradient (the flat J-vector
bit for bit); prefill logits and cache and 3 decode steps past the
patches, from the port's cache and from the reference's carried across,
then against the port's full forward; one REGTOP-k fused sparse train
step through both train steps; the train and serve launchers; and
``param_count`` of all ten registered architectures against the
reference's, with Phi-3-vision's cuts on the card.

The weights are drawn by the port's init and carried into the
reference's tree, every norm scale moved off its init value by numpy
noise from a seed (test_torch_moe.py's ``reference_init``).

Tolerances: test_torch_moe.py's RTOL 1e-5, ATOL 1e-6, GRAD_ATOL 4e-6 and
SERVE_TOL 1e-5 against the reference; tests/test_models.py's FULL_RTOL
2e-4 of the largest logit against the full forward."""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_moe import (  # noqa: E402
    PAL, check_fused_step, check_loss_and_gradient, check_prefill_and_decode,
    reference_grad, reference_init, torch_batch)
from torch_threads import one_thread  # noqa: E402,F401

from repro.configs import base as jbase  # noqa: E402
from repro.data import lm_batch as jax_lm_batch  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.flatten import tree_size  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCH = "phi-3-vision-4.2b"
FULL_RTOL = 2e-4
ARCHS = ("stablelm-3b", "starcoder2-7b", "qwen1.5-32b", "phi-3-vision-4.2b",
         "granite-8b", "granite-moe-3b-a800m", "xlstm-125m", "whisper-small",
         "jamba-v0.1-52b", "deepseek-v2-lite-16b")


def cfgs():
    """(reference, port) reduced configs."""
    return [mod.reduced_config(mod.get_config(ARCH)) for mod in (jbase, tbase)]


def patches(batch, seed=3):
    return {"patches": np.random.default_rng(seed).standard_normal(
        (batch, 16, 128)).astype(np.float32)}


@pytest.fixture(scope="module")
def reference():
    """(reference config, port config, the reference's parameters, its
    reference_grad on a batch of 4 x 32 tokens, the first 16 positions
    patches with no loss)."""
    jcfg, tcfg = cfgs()
    jparams = reference_init(tcfg)
    return jcfg, tcfg, jparams, reference_grad(jcfg, jparams,
                                               stubs=patches(4))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    """``param_count`` equals the reference's at full size and reduced,
    and the port's reduced init holds that many elements."""
    jfull, tfull = jbase.get_config(arch), tbase.get_config(arch)
    assert tfull.param_count() == jfull.param_count()
    jred, tred = jbase.reduced_config(jfull), tbase.reduced_config(tfull)
    assert tred.param_count() == jred.param_count() == tree_size(
        tfm.init_params(tred, torch.Generator(), "meta"))


def test_the_registry_holds_every_family():
    """The port registers the reference's ten architectures, every
    family among them; an unknown name is a KeyError listing them."""
    assert sorted(tbase.list_archs()) == sorted(jbase.list_archs()) \
        == sorted(ARCHS)
    assert {tbase.get_config(a).family for a in ARCHS} == {
        "dense", "moe", "ssm", "hybrid", "vlm", "audio"}
    with pytest.raises(KeyError, match="whisper-small"):
        tbase.get_config("not-an-arch")


@pytest.mark.parametrize("seq", [8, 24])
def test_patch_overwrite_is_bitwise(reference, seq):
    """``embed_batch`` with 16 patches over 8 tokens (every position a
    patch) and over 24 (the last 8 token rows): bit for bit the jitted
    reference's ``embed_batch``."""
    jcfg, tcfg, jparams, _ = reference
    tokens = np.random.default_rng(5).integers(0, 512, (2, seq)).astype(
        np.int32)
    stubs = patches(2, seed=6)
    want = jax.jit(lambda p, b: jtfm.embed_batch(p, b, jcfg, PAL, False))(
        jparams, {"tokens": tokens, **stubs})
    got = tfm.embed_batch(params_from_jax(jparams),
                          torch.from_numpy(tokens).long(), tcfg,
                          patches=torch.from_numpy(stubs["patches"]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    n = min(seq, 16)
    assert np.array_equal(got[:, :n].numpy(), stubs["patches"][:, :n])


@pytest.mark.parametrize("arch,stub", [(ARCH, "patches"),
                                       ("whisper-small", "frames"),
                                       ("stablelm-3b", None)])
def test_synthetic_batch_carries_the_stub(arch, stub):
    """``lm_batch`` of the reduced model: a vision model's patches and
    its patch positions' targets -1 (as tests/test_models.py checks the
    reference's), an audio model's frames with every target but the last
    kept, neither for a model without a stub; the same keys and shapes
    as the reference's batch."""
    cfg = tbase.reduced_config(tbase.get_config(arch))
    batch = lm_batch(cfg, 2, 64, 0, 0, "cpu")
    want = jax_lm_batch(jbase.reduced_config(jbase.get_config(arch)), 2, 64,
                        0, 0)
    assert {key: tuple(val.shape) for key, val in batch.items()} == {
        key: tuple(val.shape) for key, val in want.items()}
    if stub is not None:
        assert batch[stub].dtype == torch.float32
        assert tuple(batch[stub].shape) == (2, 16, 128)
    masked = (batch["targets"] == -1).numpy()
    assert np.array_equal(masked, np.asarray(want["targets"]) == -1)
    assert masked[:, :16].all() == (stub == "patches")
    assert masked[:, -1].all() and not masked[:, 16:-1].any()


def test_loss_and_gradient_match_reference(reference):
    check_loss_and_gradient(*reference, patches(4))


def test_prefill_and_decode_match_reference_and_the_full_forward(reference):
    """check_prefill_and_decode over a prompt of 20 (16 patches, 4 text
    tokens) and 3 decode steps past the patches, then the prefill and
    each step's logits within FULL_RTOL of the largest logit of the full
    forward on the same patches."""
    jcfg, tcfg, jparams, _ = reference
    stubs = patches(2, seed=7)
    tokens, got = check_prefill_and_decode(jcfg, tcfg, jparams, prompt=20,
                                           stubs=stubs)
    with torch.no_grad():
        full = tfm.full_logits(params_from_jax(jparams),
                               torch_batch(tokens, stubs=stubs), tcfg)
    scale = float(full.abs().max())
    for i, logits in enumerate(got):
        err = float((logits - full[:, 19 + i]).abs().max()) / scale
        assert err < FULL_RTOL, (i, err)


def test_fused_step_matches_reference(reference):
    check_fused_step(*reference, stubs=patches(4))


def test_launchers_take_phi3_vision():
    """``--arch phi-3-vision-4.2b --smoke``: the train launcher's main path
    for 2 steps of 24 tokens (J the config's count, the loss finite over
    the 8 text targets a row), and ``serve()`` with a prompt of 20: the
    prompts' patches from the seed, the last decode step's logits within
    FULL_RTOL of the full forward on them."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch.train import parse_args, run_config, train
    run = run_config(parse_args(["--arch", ARCH, "--smoke", "--steps", "2",
                                 "--comm", "sparse", "--pipeline", "fused"]))
    out = train(run, device="cpu", batch=2, seq=24, fixed_batch=True,
                log=lambda msg: None)
    assert out["params"] == run.model.param_count()
    assert all(np.isfinite([rec["loss"] for rec in out["history"]]))
    run = serve_launcher.run_config(serve_launcher.parse_args(
        ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "20",
         "--new-tokens", "3"]))
    params = tfm.init_params(run.model, torch.Generator().manual_seed(1),
                             "cpu")
    res = serve_launcher.serve(run, device="cpu", prompt_len=20,
                               new_tokens=3, params=params,
                               log=lambda msg: None)
    assert tuple(res["batch"]["patches"].shape) == (2, 16, 128)
    with torch.no_grad():
        full = tfm.full_logits(params, dict(res["batch"], tokens=torch.cat(
            [res["prompt"], res["tokens"]], 1)), run.model)
    err = float((res["logits"] - full[:, -1]).abs().max())
    assert err / float(full.abs().max()) < FULL_RTOL, err


def test_the_full_config_counts_the_references_parameters():
    """Phi-3-vision at full width: 3,821,079,552 parameters at 32 layers,
    1,103,023,104 at the 8 that one card trains and 876,518,400 at 6,
    each the reference's count."""
    full = tbase.get_config(ARCH)
    for depth, want in ((32, 3_821_079_552), (8, 1_103_023_104),
                        (6, 876_518_400)):
        jcut, tcut = (dataclasses.replace(mod.get_config(ARCH),
                                          n_layers=depth)
                      for mod in (jbase, tbase))
        assert tcut.param_count() == jcut.param_count() == want, depth
    assert tree_size(tfm.init_params(full, torch.Generator(), "meta")) == \
        3_821_079_552
