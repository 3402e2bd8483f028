"""Bidirectional MLA (an MLA encoder-decoder's encoder) in the port
against the reference on the same weights, in MLA's expanded and
absorbed forms: ``attn_fwd_full(causal=False)`` of one reduced MLA layer
at 12 and 1500 positions (at 1500 the reference takes its one-softmax
``_sdpa`` expanded and one key chunk of 1500 absorbed, the port its
chunked online softmax), and the loss and flat gradient of a reduced
MLA encoder-decoder (reduced Whisper-small with DeepSeek-V2-Lite's
reduced MLA fields: its encoder and its decoder's self-attention MLA,
its cross-attention the plain kind, as the reference keeps it).

Tolerances: tests/test_torch_moe.py's RTOL 1e-5 and ATOL 1e-6 on the
attention, its GRAD_ATOL 4e-6 on the flat gradient (repeated tokens'
rows of the table sum in another order).

The analytic count of an MLA encoder-decoder is the reference's
``count_params_analytic`` in both packages, which counts each decoder
layer's cross-attention as MLA; the drawn trees (both packages') hold
the plain cross-attention leaves, so the test compares the trees and
not the count."""
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
    ATOL, GRAD_ATOL, PAL, RTOL, live, torch_batch)
from torch_threads import one_thread  # noqa: E402,F401

from repro.configs import base as jbase  # noqa: E402
from repro.core.flatten import TreeFlattener as JaxFlattener  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.flatten import TreeFlattener, tree_items  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import loss_and_aux  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

FORMS = {"expanded": False, "absorbed": True}
# DeepSeek-V2-Lite's reduced MLA fields
MLA = dict(attn_kind="mla", kv_lora_rank=32, rope_head_dim=16, v_head_dim=32)


def layer_cfgs(absorb: bool):
    """(reference, port) reduced DeepSeek-V2-Lite configs in one form."""
    return [dataclasses.replace(
        mod.reduced_config(mod.get_config("deepseek-v2-lite-16b")),
        mla_absorb=absorb) for mod in (jbase, tbase)]


def encdec_cfgs(absorb: bool):
    """(reference, port) reduced Whisper-small with MLA attention."""
    return [dataclasses.replace(
        mod.reduced_config(mod.get_config("whisper-small")),
        mla_absorb=absorb, **MLA) for mod in (jbase, tbase)]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("seq,batch", [(12, 2), (1500, 1)])
def test_bidirectional_mla_layer_matches_reference(form, seq, batch):
    """``attn_fwd_full(causal=False)`` on the same weights and input
    within RTOL / ATOL of the jitted reference's."""
    jcfg, tcfg = layer_cfgs(FORMS[form])
    p = live(params_to_jax(tattn.init_attention(
        torch.Generator().manual_seed(5), tcfg)), 5)
    x = np.random.default_rng(5).standard_normal(
        (batch, seq, 128)).astype(np.float32)
    want = jax.jit(lambda p, x: jattn.attn_fwd_full(
        p, x, jcfg, PAL, causal=False))(p, x)
    with torch.no_grad():
        got = tattn.attn_fwd_full(params_from_jax(p), torch.from_numpy(x),
                                  tcfg, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bidirectional_mla_is_not_causal():
    """The encoder's MLA attends to later positions: changing the last
    position's input moves the first position's output (and the causal
    form's does not move)."""
    _, tcfg = layer_cfgs(False)
    p = tattn.init_attention(torch.Generator().manual_seed(6), tcfg)
    x = torch.randn(1, 8, 128, generator=torch.Generator().manual_seed(6))
    y = x.clone()
    y[:, -1] += 1.0
    with torch.no_grad():
        for causal in (False, True):
            a = tattn.attn_fwd_full(p, x, tcfg, causal=causal)[:, 0]
            b = tattn.attn_fwd_full(p, y, tcfg, causal=causal)[:, 0]
            assert torch.equal(a, b) == causal


@pytest.mark.parametrize("form", FORMS)
def test_mla_encoder_decoder_loss_and_gradient(form):
    """A reduced MLA encoder-decoder builds (``check_model``), its
    encoder's self-attention holds the MLA leaves and every decoder
    layer's ``cross`` the plain ones, and its loss and flat gradient on
    4 x 32 tokens and 4 x 16 frames are the jitted reference's within
    RTOL / GRAD_ATOL, the flat J-vector bit for bit."""
    jcfg, tcfg = encdec_cfgs(FORMS[form])
    tfm.check_model(tcfg)
    tree = tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert "dkv" in tree["encoder"]["blocks"]["attn"]
    assert sorted(tree["blocks"]["l0"]["cross"]) == ["bk", "bq", "bv", "wk",
                                                     "wo", "wq", "wv"]
    jparams = live(params_to_jax(tree), 0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    targets = rng.integers(0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    frames = rng.standard_normal((4, 16, 128)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets),
          "frames": jnp.asarray(frames)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jb, jcfg, PAL), has_aux=True))(jparams)
    tparams = params_from_jax(jparams)
    jflat, tflat = JaxFlattener(jparams), TreeFlattener(tparams)
    assert np.array_equal(tflat.flatten(tparams).numpy(),
                          np.asarray(jflat.flatten(jparams)))
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_items(tparams)]
    loss, _ = loss_and_aux(tparams, torch_batch(
        tokens, targets, {"frames": frames}), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(tflat.flatten(list(grads)).numpy(),
                               np.asarray(jflat.flatten(jgrads)), rtol=RTOL,
                               atol=GRAD_ATOL)
