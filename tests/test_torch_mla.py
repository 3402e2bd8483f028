"""The port's MLA attention and reduced DeepSeek-V2-Lite (MLA, a shared
expert, a dense prefix layer) against the reference on the same weights,
in MLA's expanded and absorbed forms: the attention layer's forward,
prefill (its output and ``{ckv, krope}`` cache) and decode; the model's
loss and flat gradient (its flat J-vector bit for bit, the ``prefix``
list included); prefill and decode logits from the port's cache and from
the reference's carried across; one REGTOP-k fused sparse train step
through both train steps; the train and serve launchers (``--mla-absorb``)
and a checkpoint of the prefix tree read by the reference.

The cache is held to SERVE_TOL, not bit for bit: ``ckv`` is an rmsnorm
and ``krope`` a rotation, and XLA's CPU program rounds their rsqrt and
contracted multiply-adds differently from torch's (on dyadic inputs, where
every product and sum is exact, about a fifth of the entries still differ
by one ulp). What the port writes into its cache is bit for bit what its
projection computed. The shared helpers are tests/test_torch_moe.py's."""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_moe import (  # noqa: E402
    PAL, SERVE_TOL, check_fused_step, check_loss_and_gradient,
    check_prefill_and_decode, check_train_launcher, live, reference_grad,
    reference_init)
from torch_threads import one_thread  # noqa: E402,F401

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
FORMS = {"expanded": False, "absorbed": True}


def _cfgs(absorb: bool):
    return [dataclasses.replace(mod.reduced_config(mod.get_config(ARCH)),
                                mla_absorb=absorb) for mod in (jbase, tbase)]


@pytest.fixture(scope="module")
def reference():
    """(reference config, port config, the reference's parameters, its
    reference_grad) of the reduced model in its expanded form, computed
    once for the module."""
    jcfg, tcfg = _cfgs(False)
    jparams = reference_init(tcfg)
    return jcfg, tcfg, jparams, reference_grad(jcfg, jparams)


@pytest.mark.parametrize("form", FORMS)
def test_mla_layer_matches_reference(form):
    """One MLA layer on the same weights and input (2, 12, 128):
    prefill's output (bit for bit the port's full-sequence forward) and
    cache, and 3 decode steps' outputs and caches, within SERVE_TOL of
    the reference's; the prefill cache holds bit for bit the port's own
    projection of the prompt, zeros past it."""
    jcfg, tcfg = _cfgs(FORMS[form])
    p = live(params_to_jax(tattn.init_attention(
        torch.Generator().manual_seed(3), tcfg)), 3)
    tp = params_from_jax(p)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 15, 128)).astype(np.float32)
    xt = torch.from_numpy(x)
    prompt, slots = 12, 16
    jy, jcache = jax.jit(lambda p, x: jattn.attn_prefill(
        p, x, jcfg, PAL, max_seq=slots))(p, x[:, :prompt])
    cache = tattn.init_cache(tcfg, 2, slots, torch.float32)
    with torch.inference_mode():
        y = tattn.attn_prefill(tp, xt[:, :prompt], cache, tcfg)
        _, ckv, krope = tattn.proj_mla(tp, xt[:, :prompt], tcfg,
                                       torch.arange(prompt))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SERVE_TOL,
                               atol=SERVE_TOL)
    assert torch.equal(tattn.attn_fwd_full(tp, xt[:, :prompt], tcfg), y)
    for name, own in (("ckv", ckv), ("krope", krope)):
        assert torch.equal(cache[name][:, :prompt], own), name
        assert not cache[name][:, prompt:].any(), name
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=SERVE_TOL,
                                   atol=SERVE_TOL, err_msg=name)
    jdec = jax.jit(lambda p, x, c, pos: jattn.attn_decode(p, x, c, pos, jcfg,
                                                          PAL))
    for pos in range(prompt, prompt + 3):
        jy, jcache = jdec(p, x[:, pos:pos + 1], jcache, jnp.int32(pos))
        with torch.inference_mode():
            y = tattn.attn_decode(tp, xt[:, pos:pos + 1], cache,
                                  torch.tensor(pos, dtype=torch.int32), tcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SERVE_TOL,
                                   atol=SERVE_TOL, err_msg=f"decode {pos}")
        for name in ("ckv", "krope"):
            np.testing.assert_allclose(
                cache[name].numpy(), np.asarray(jcache[name]),
                rtol=SERVE_TOL, atol=SERVE_TOL, err_msg=f"{name} at {pos}")


def test_loss_and_gradient_match_reference(reference):
    assert "prefix" in reference[2]
    check_loss_and_gradient(*reference)


@pytest.mark.parametrize("form", FORMS)
def test_prefill_and_decode_match_reference(reference, form):
    check_prefill_and_decode(*_cfgs(FORMS[form]), reference[2])


def test_fused_step_matches_reference(reference):
    check_fused_step(*reference)


def test_train_launcher_takes_deepseek():
    check_train_launcher(ARCH)


def test_serve_launcher_serves_absorbed_mla(capsys):
    """``--mla-absorb`` serves the MLA model in its absorbed form."""
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", ARCH, "--smoke", "--mla-absorb", "--device",
                   "cpu", "--batch", "2", "--prompt-len", "8",
                   "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert "absorbed MLA" in out and "decode 2 steps" in out


def test_checkpoint_of_the_prefix_reads_in_the_reference(reference,
                                                         tmp_path):
    """The port's checkpoint of the model's parameters (the ``prefix``
    list under the keys ``jax.tree_util.keystr`` gives it) restores bit
    for bit into the reference's tree, and back into the port's."""
    from repro.checkpoint import io as jio
    from repro_torch.checkpoint import io as tio
    from repro_torch.core.flatten import tree_items
    from repro_torch.models import init_params
    cfg = tbase.reduced_config(tbase.get_config(ARCH))
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    empty = {"step": torch.zeros((), dtype=torch.int32)}
    tio.save_checkpoint(str(tmp_path), 1, params, empty, empty)
    with np.load(tmp_path / "step_00000001.params.npz") as d:
        assert "['prefix'][0]['attn']['dkv']" in d.files
    jtmpl = jax.tree_util.tree_map(np.zeros_like, reference[2])
    got = jio.restore_checkpoint(str(tmp_path), 1, jtmpl,
                                 {"step": np.int32(0)},
                                 {"step": np.int32(0)})[0]
    back = tio.restore_checkpoint(str(tmp_path), 1, params, empty, empty)[0]
    items = tree_items(params)
    assert [p for p, _ in tree_items(back)] == [p for p, _ in items]
    for (path, want), (_, one), (_, two) in zip(
            items, tree_items(jax.device_get(got)), tree_items(back)):
        assert np.array_equal(np.asarray(one), want.numpy()), path
        assert torch.equal(two, want), path
