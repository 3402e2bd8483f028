"""The port's Mamba mixer and reduced Jamba-v0.1 (Mamba with attention at
position 4 of each super-block of 8, MoE on the odd positions) against
the reference on the same weights: the associative scan against
``jax.lax.associative_scan``, ``mamba_fwd`` (the output and the decode
cache it returns) over two chunks (S = 1024) and over one chunk of S
(S = 600, which 512 does not divide), one ``mamba_decode`` step from a
reference state, the loss and flat gradient (the flat J-vector bit for
bit, ``A_log`` and ``D`` first), prefill logits and every cache leaf,
then 3 decode steps from the port's cache and from the reference's
carried across, one REGTOP-k fused sparse train step through both train
steps (the compressor bitwise on the reference's own gradient), the
train launcher; ``ModelConfig.param_count`` against the reference's for
every registered arch, and a data-parallel batch of reduced xLSTM and
Jamba served over a gloo group of 2.

The weights are the port's init carried into the reference's tree, with
the norm scales, ``D`` and ``conv_b`` moved by numpy noise from a seed
(tests/test_torch_xlstm.py's ``live``).

Tolerances: test_torch_moe.py's RTOL 1e-5, ATOL 1e-6 and GRAD_ATOL 4e-6,
SERVE_TOL 1e-5. The scan replicates the reference's odd/even recursion,
so it computes the same products in the same order; XLA's CPU program
contracts b2 + a2 * b1 into a fused multiply-add where the port rounds
the product first, an ulp a combine at most: the worst output error
seen is 2.4e-7 on entries up to 0.94 (S = 1024)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_moe import (  # noqa: E402
    PAL, SERVE_TOL, check_fused_step, check_loss_and_gradient,
    check_prefill_and_decode, check_train_launcher, reference_grad)
from test_torch_xlstm import cfgs, close, live, reference_init  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

from repro.configs import base as jbase  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.flatten import TreeFlattener, tree_size  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ARCH = "jamba-v0.1-52b"
HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("stablelm-3b", "starcoder2-7b", "qwen1.5-32b", "granite-8b",
         "granite-moe-3b-a800m", "deepseek-v2-lite-16b", "xlstm-125m",
         ARCH)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 37, 512])
def test_associative_scan_matches_jax(n):
    """The scan of (a, b) pairs under (a1 a2, b2 + a2 b1) along dim 1 at
    odd, even and power-of-two lengths: within RTOL / ATOL of the jitted
    ``jax.lax.associative_scan`` (contracted multiply-adds aside, the
    same operations), and of a sequential fp64 recurrence."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[1] + e2[0] * e1[1]
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    ta, tb = tmamba.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    close(ta, ja, "a")
    close(tb, jb, "b")
    h, seq = np.zeros((2, 3, 4)), []
    for t in range(n):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        seq.append(h)
    close(tb, np.stack(seq, 1), "b, fp64 recurrence")


def _mamba_case(seq):
    jcfg, tcfg = cfgs(ARCH)
    p = live(params_to_jax(tmamba.init_mamba(
        torch.Generator().manual_seed(1), tcfg)), 1)
    x = np.random.default_rng(seq).standard_normal((2, seq, 128)).astype(
        np.float32)
    jy, jst = jax.jit(lambda p, x: jmamba.mamba_fwd(
        p, x, jcfg, PAL, return_state=True))(p, x)
    return jcfg, tcfg, p, x, jy, jax.device_get(jst)


@pytest.mark.parametrize("seq", [1024, 600], ids=["two_chunks", "chunk_s"])
def test_mamba_fwd_matches_reference(seq):
    """Over two chunks of 512 (the state carried from one to the next)
    and over one chunk of 600: the output and the cache ``{conv, h}``
    within RTOL / ATOL; the conv ring, the last 3 inputs before the
    conv, bit for bit."""
    _, tcfg, p, x, jy, jst = _mamba_case(seq)
    cache = tmamba.init_mamba_cache(tcfg, 2, torch.float32)
    with torch.no_grad():
        y = tmamba.mamba_fwd(params_from_jax(p), torch.from_numpy(x), tcfg,
                             cache)
    close(y, jy, "y")
    assert sorted(cache) == sorted(jst) == ["conv", "h"]
    assert np.array_equal(cache["conv"].numpy(), jst["conv"])
    close(cache["h"], jst["h"], "h")


def test_mamba_remat_recomputes_the_same_gradient():
    """Under ``cfg.remat`` each chunk is recomputed in the backward pass:
    the same gradient, bit for bit, as without."""
    _, tcfg, p, x, _, _ = _mamba_case(1024)
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        tp = params_from_jax(p)
        leaves = [tp[key].requires_grad_(True) for key in sorted(tp)]
        y = tmamba.mamba_fwd(tp, torch.from_numpy(x), cfg)
        grads.append(torch.autograd.grad((y * y).sum(), leaves))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_mamba_decode_matches_reference():
    """One decode step from the reference's cache after 600 steps: the
    output and the new conv ring and h within RTOL / ATOL."""
    jcfg, tcfg, p, _, _, jst = _mamba_case(600)
    x1 = np.random.default_rng(4).standard_normal((2, 1, 128)).astype(
        np.float32)
    jy, jnew = jax.jit(lambda p, x, c: jmamba.mamba_decode(
        p, x, c, jcfg, PAL))(p, x1, jst)
    cache = {key: torch.from_numpy(np.array(val)) for key, val in jst.items()}
    with torch.no_grad():
        y = tmamba.mamba_decode(params_from_jax(p), torch.from_numpy(x1),
                                cache, tcfg)
    close(y, jy, "y")
    for key, want in jax.device_get(jnew).items():
        close(cache[key], want, key)


@pytest.fixture(scope="module")
def reference():
    jcfg, tcfg = cfgs(ARCH)
    jparams = reference_init(tcfg)
    return jcfg, tcfg, jparams, reference_grad(jcfg, jparams)


def test_jamba_layer_pattern(reference):
    """Attention at position 4 of 8, Mamba elsewhere with ``norm1``
    before it, MoE on the odd positions; ``A_log`` and ``D`` lead each
    Mamba layer's leaves in the flat order of both packages."""
    _, tcfg, jparams, _ = reference
    assert tfm.layer_pattern(tcfg) == [
        ("attn" if j == 4 else "mamba", "moe" if j % 2 else "dense")
        for j in range(8)]
    for j in range(8):
        layer = jparams["blocks"][f"l{j}"]
        assert "norm1" in layer and ("attn" in layer) == (j == 4)
    paths = TreeFlattener(params_from_jax(jparams)).paths
    first = paths.index(("blocks", "l0", "mamba", "A_log"))
    assert paths[first + 1] == ("blocks", "l0", "mamba", "D")
    assert paths[first + 2] == ("blocks", "l0", "mamba", "conv_b")


def test_loss_and_gradient_match_reference(reference):
    check_loss_and_gradient(*reference)


def test_prefill_and_decode_match_reference(reference):
    check_prefill_and_decode(*reference[:3])


def test_fused_step_matches_reference(reference):
    check_fused_step(*reference)


def test_train_launcher_takes_jamba():
    check_train_launcher(ARCH)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    """``ModelConfig.param_count`` equals the reference's for the full
    config, its depth cut to the dense prefix and one super-block, and
    its reduced form, whose port init holds that many elements."""
    jfull, tfull = jbase.get_config(arch), tbase.get_config(arch)
    period = len(tfm.layer_pattern(tfull))
    for cut in ({}, {"n_layers": tfull.n_dense_prefix + period}):
        assert dataclasses.replace(tfull, **cut).param_count() == \
            dataclasses.replace(jfull, **cut).param_count()
    jred, tred = jbase.reduced_config(jfull), tbase.reduced_config(tfull)
    assert tred.param_count() == jred.param_count() == tree_size(
        tfm.init_params(tred, torch.Generator(), "meta"))
    want = {"xlstm-125m": 164_669_952, ARCH: 51_570_315_264}
    if arch in want:
        assert tfull.param_count() == want[arch]
    if arch == ARCH:
        assert dataclasses.replace(tfull, n_layers=8).param_count() == \
            13_295_235_072


@pytest.mark.parametrize("arch", ["xlstm-125m", ARCH])
def test_data_parallel_serving_at_world_2(arch, tmp_path):
    """A batch of 4 over a gloo group of 2: the gathered prefill logits
    and 3 decode steps' within SERVE_TOL of one process serving the whole
    batch, from the builders' own prefill and from a one-rank prefill's
    cache that ``shard_decode_cache`` cut by rows (each recurrent leaf
    holds 2 rows a rank)."""
    cfg = tbase.reduced_config(tbase.get_config(arch))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = TreeFlattener(params).flatten(params).numpy()
    tokens = np.random.default_rng(9).integers(0, 512, (4, 11))
    prompt = 8
    inp = tmp_path / "in.npz"
    np.savez(inp, arch=arch, init_params=flat, tokens=tokens, prompt=prompt)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"),
         "recurrent_serve", str(r), "2", str(tmp_path / "rendezvous"),
         str(inp), str(tmp_path / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        logits, cache = tfm.prefill(params, {"tokens": t[:, :prompt]}, cfg,
                                    11)
        want = [logits.numpy()]
        for i in range(prompt, 11):
            step, cache = tfm.decode_step(params, cache, t[:, i:i + 1], cfg)
            want.append(step.numpy())
    for out in outs:
        assert not out["jax_imported"]
        close(out["prefill"], want[0], "prefill", SERVE_TOL, SERVE_TOL)
        for name in ("own", "cut"):
            for i in range(3):
                close(out[f"{name}_decode_{i}"], want[i + 1],
                      f"{name} {i}", SERVE_TOL, SERVE_TOL)
        shapes = {key: val for key, val in out.items()
                  if key.startswith("shape_")}
        assert shapes and all(val[1] == 2 for val in shapes.values())

