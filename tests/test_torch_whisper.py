"""The port's encoder-decoder (reduced Whisper-small: a 2-layer
bidirectional encoder over 16 stub frames, 2 causal decoder layers with
cross-attention, layernorm, GELU, QKV bias, sinusoidal positions)
against the reference on the same weights: bidirectional attention at
1500 positions, where the reference takes its one-softmax ``_sdpa``; the
encoder's output at 16 and 1500 frames; cross-attention in its
full-sequence and decode forms; the model's loss and flat gradient (the
flat J-vector bit for bit, ``encoder`` between ``embed`` and
``final_norm``, ``cross`` and ``norm_x`` in each decoder layer); prefill
logits and every cache leaf, the ``cross`` leaf included, and 3 decode
steps from the port's cache and from the reference's carried across,
then the same logits against the port's full forward; one REGTOP-k fused
sparse train step through both train steps; the train and serve
launchers; Whisper-small's count at full width; and serving over a gloo
group of 2, a data-parallel batch and context-parallel decode.

The weights are drawn by the port's init and carried into the
reference's tree, every norm scale and bias, QKV bias and MLP bias moved
off its init value by numpy noise from a seed.

Tolerances: test_torch_moe.py's RTOL 1e-5, ATOL 1e-6, GRAD_ATOL 4e-6 and
SERVE_TOL 1e-5 against the reference; tests/test_models.py's FULL_RTOL
2e-4 of the largest logit against the full forward."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_moe import (  # noqa: E402
    ATOL, HERE, PAL, RTOL, SERVE_TOL, check_fused_step,
    check_loss_and_gradient, check_prefill_and_decode, reference_grad,
    torch_batch)
from torch_threads import one_thread  # noqa: E402,F401

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.flatten import TreeFlattener, tree_size  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCH = "whisper-small"
FULL_RTOL = 2e-4
# leaves at a constant init value (ones or zeros), moved so that a wrong
# use shows
MOVED = ("scale", "bias", "bq", "bk", "bv", "up_b", "down_b")


def cfgs():
    """(reference, port) reduced configs."""
    return [mod.reduced_config(mod.get_config(ARCH)) for mod in (jbase, tbase)]


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


def frames(batch, n=16, seed=3):
    return {"frames": np.random.default_rng(seed).standard_normal(
        (batch, n, 128)).astype(np.float32)}


def close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def reference():
    """(reference config, port config, the reference's parameters, its
    reference_grad on a batch of 4 x 32 tokens and 4 x 16 frames)."""
    jcfg, tcfg = cfgs()
    jparams = live(params_to_jax(tfm.init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu")))
    return jcfg, tcfg, jparams, reference_grad(jcfg, jparams,
                                               stubs=frames(4))


def test_bidirectional_attention_at_1500_matches_the_one_softmax():
    """``full_attention`` (query chunks of 1024 and 476 over one key
    chunk of 1500, normalised after the value product) against the
    reference's ``_sdpa_chunked(causal=False)``, which at 1500 positions
    (1500 % 1024 != 0) takes the one-softmax ``_sdpa``: within RTOL /
    ATOL."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 1500, 2, 32)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(1500)
    want = jax.jit(lambda q, k, v: jattn._sdpa_chunked(
        q, k, v, pos, pos, 32 ** -0.5, causal=False))(q, k, v)
    got = tattn.full_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                               32 ** -0.5)
    close(got, want, "o")


@pytest.mark.parametrize("n,batch", [(16, 2), (1500, 1)])
def test_encoder_matches_reference(reference, n, batch):
    """``encode`` (sinusoidal positions, 2 bidirectional layers, the
    encoder's final norm) over n frames within RTOL / ATOL of the jitted
    reference's."""
    jcfg, tcfg, jparams, _ = reference
    x = frames(batch, n)["frames"]
    want = jax.jit(lambda p, f: jtfm.encode(p, f, jcfg, PAL))(jparams, x)
    with torch.no_grad():
        got = tfm.encode(params_from_jax(jparams), torch.from_numpy(x), tcfg)
    close(got, want, "enc_out")


def test_cross_attention_matches_reference(reference):
    """One decoder layer's cross-attention (its moved weights and
    biases) over an encoder output of 16 positions: ``cross_kv`` against
    ``init_cross_kv``, the full-sequence form of 12 queries against
    ``attn_fwd_full(cross_kv=...)``, and one decode query against
    ``attn_decode(cross_kv=...)``, within RTOL / ATOL. Cross-attention's
    leaves are the plain ones, for an MLA config too (the reference's
    ``init_attention(cross=True)``)."""
    jcfg, tcfg, _, _ = reference
    p = live(params_to_jax(tattn.init_attention(
        torch.Generator().manual_seed(5), tcfg, cross=True)), 5)
    assert sorted(p) == ["bk", "bq", "bv", "wk", "wo", "wq", "wv"]
    mla = tbase.reduced_config(tbase.get_config("deepseek-v2-lite-16b"))
    assert sorted(tattn.init_attention(torch.Generator(), mla, cross=True)) \
        == ["wk", "wo", "wq", "wv"]
    rng = np.random.default_rng(6)
    enc, x = (rng.standard_normal(shape).astype(np.float32)
              for shape in ((2, 16, 128), (2, 13, 128)))

    def ref(p, enc, x):
        kv = jattn.init_cross_kv(p, enc, jcfg, PAL)
        full = jattn.attn_fwd_full(p, x[:, :12], jcfg, PAL, causal=False,
                                   cross_kv=kv)
        dec, _ = jattn.attn_decode(p, x[:, 12:], None, 12, jcfg, PAL,
                                   cross_kv=kv)
        return kv, full, dec
    (jk, jv), jfull, jdec = jax.jit(ref)(p, enc, x)
    tp, xt = params_from_jax(p), torch.from_numpy(x)
    k, v = tattn.cross_kv(tp, torch.from_numpy(enc), tcfg)
    close(k, jk, "k")
    close(v, jv, "v")
    close(tattn.cross_attention(tp, xt[:, :12], k, v, tcfg), jfull, "full")
    close(tattn.cross_attention(tp, xt[:, 12:], k, v, tcfg), jdec,
          "decode")


def test_loss_and_gradient_match_reference(reference):
    """The parameter tree's layout, then check_loss_and_gradient: the
    flat J-vector bitwise (its order), the loss and the flat gradient,
    the encoder's reached through cross-attention only."""
    jcfg, tcfg, jparams, ref = reference
    assert sorted(jparams) == ["blocks", "embed", "encoder", "final_norm"]
    assert sorted(jparams["blocks"]["l0"]) == [
        "attn", "cross", "mlp", "norm1", "norm2", "norm_x"]
    assert sorted(jparams["encoder"]["blocks"]) == [
        "attn", "mlp", "norm1", "norm2"]
    check_loss_and_gradient(jcfg, tcfg, jparams, ref, frames(4))


def test_prefill_and_decode_match_reference_and_the_full_forward(reference):
    """check_prefill_and_decode (every cache leaf, ``cross`` among them,
    within SERVE_TOL of the reference's; decode from both caches), then
    the prefill and each decode step's logits within FULL_RTOL of the
    largest logit of the full forward on the same frames."""
    jcfg, tcfg, jparams, _ = reference
    stubs = frames(2, seed=7)
    tokens, got = check_prefill_and_decode(jcfg, tcfg, jparams, stubs=stubs)
    with torch.no_grad():
        full = tfm.full_logits(params_from_jax(jparams),
                               torch_batch(tokens, stubs=stubs), tcfg)
    scale = float(full.abs().max())
    for i, logits in enumerate(got):
        err = float((logits - full[:, 11 + i]).abs().max()) / scale
        assert err < FULL_RTOL, (i, err)


def test_fused_step_matches_reference(reference):
    """check_fused_step without its exact-zeros check: the gradient of
    every attention layer's key bias ``bk`` is zero in exact arithmetic
    (the softmax ignores the shift q . bk that it adds to all of a
    query's scores) and comes out of both packages as rounding noise
    below 1e-9, exactly 0 at other entries in each (26 of the 768 bk
    entries differ in being 0), so the error there is held to GRAD_ATOL
    with the rest."""
    check_fused_step(*reference, stubs=frames(4), exact_zeros=False)


def test_launchers_take_whisper():
    """``--arch whisper-small --smoke``: the train launcher's main path
    for 2 steps (J the config's count, the loss finite: its batches
    carry frames), and ``serve()``: prompts with frames from the seed,
    a cross cache of (2 layers, 2 rows, 16 frames, 4 heads, 32), and
    the last decode step's logits within FULL_RTOL of the full forward
    of the prompt and the generated tokens on the same frames."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch.train import parse_args, run_config, train
    run = run_config(parse_args(["--arch", ARCH, "--smoke", "--steps", "2",
                                 "--comm", "sparse", "--pipeline", "fused"]))
    out = train(run, device="cpu", batch=2, seq=16, fixed_batch=True,
                log=lambda msg: None)
    assert out["params"] == run.model.param_count()
    assert all(np.isfinite([rec["loss"] for rec in out["history"]]))
    run = serve_launcher.run_config(serve_launcher.parse_args(
        ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "3"]))
    params = tfm.init_params(run.model, torch.Generator().manual_seed(1),
                             "cpu")
    res = serve_launcher.serve(run, device="cpu", prompt_len=8,
                               new_tokens=3, params=params,
                               log=lambda msg: None)
    assert tuple(res["cache"]["cross"]["k"].shape) == (2, 2, 16, 4, 32)
    assert tuple(res["batch"]["frames"].shape) == (2, 16, 128)
    with torch.no_grad():
        full = tfm.full_logits(params, dict(res["batch"], tokens=torch.cat(
            [res["prompt"], res["tokens"]], 1)), run.model)
    err = float((res["logits"] - full[:, -1]).abs().max())
    assert err / float(full.abs().max()) < FULL_RTOL, err


def test_the_full_config_counts_the_references_parameters():
    """Whisper-small at full width and depth: 12 encoder and 12 decoder
    layers, J = 278,115,840, the reference's count; the meta device's
    init holds that many elements."""
    cfg = tbase.get_config(ARCH)
    assert cfg.param_count() == jbase.get_config(ARCH).param_count() \
        == 278_115_840
    assert tree_size(tfm.init_params(cfg, torch.Generator(), "meta")) == \
        278_115_840


def test_serving_over_a_gloo_group_of_2(tmp_path):
    """A batch of 4 prompts of 8 tokens with 16 frames each over a gloo
    group of 2: data-parallel (each rank 2 rows of the self-attention and
    cross caches), the gathered prefill logits and 4 decode steps' within
    SERVE_TOL of one process serving the whole batch; context-parallel
    decode of the first row (each rank 6 of the 12 slots and the whole
    cross cache) from a one-rank prefill's cache, each step's logits
    within SERVE_TOL of one process decoding that row."""
    cfg = cfgs()[1]
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(9).integers(0, 512, (4, 12))
    stubs = frames(4, seed=10)
    inp = tmp_path / "in.npz"
    np.savez(inp, arch=ARCH, init_params=TreeFlattener(params).flatten(
        params).numpy(), tokens=tokens, prompt=8, **stubs)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"),
         "encdec_serve", str(r), "2", str(tmp_path / "rendezvous"),
         str(inp), str(tmp_path / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    want = {}
    for name, b in (("dp", 4), ("cp", 1)):
        batch = torch_batch(tokens[:b], stubs={"frames": stubs["frames"][:b]})
        with torch.inference_mode():
            logits, cache = tfm.prefill(params, dict(
                batch, tokens=batch["tokens"][:, :8]), cfg, 12)
            want[f"{name}_prefill"] = logits.numpy()
            for i in range(8, 12):
                step, cache = tfm.decode_step(
                    params, cache, batch["tokens"][:, i:i + 1], cfg)
                want[f"{name}_decode_{i - 8}"] = step.numpy()
    for out in outs:
        assert not out["jax_imported"]
        assert list(out["dp_self_k"]) == [2, 2, 12, 4, 32]
        assert list(out["dp_cross_k"]) == [2, 2, 16, 4, 32]
        assert list(out["cp_self_k"]) == [2, 1, 6, 4, 32]
        assert list(out["cp_cross_k"]) == [2, 1, 16, 4, 32]
        close(out["dp_prefill"], want["dp_prefill"], "dp prefill", SERVE_TOL,
              SERVE_TOL)
        for key in want:
            if "decode" in key:
                close(out[key], want[key], key, SERVE_TOL, SERVE_TOL)
