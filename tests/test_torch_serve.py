"""The port's serving path against the reference's model functions on the
same weights: ``prefill`` (last logits and the whole cache) and 4
teacher-forced ``decode_step`` calls against ``repro.models.prefill`` and
``repro.models.decode_step`` (jitted), for reduced granite-8b,
starcoder2-7b, a tied-embedding variant without RoPE, and granite's
sliding variant with its ring buffer wrapped in the prefill and in the
decode; a reference cache carried into the port's decode (fp32, and a
bf16 cache bit for bit); the serve step's builders and the launcher.

The reference's own serving tests (its launcher, its sharded decode) are
not the oracle: the model functions are, called directly. Decode steps
are fed the same tokens in both packages (teacher forcing): greedy
tokens from two packages may part on a last-bit difference."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.parallel import Parallel  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import (cache_from_jax, cache_to_jax,  # noqa: E402
                                 params_from_jax)
from repro_torch.core.flatten import tree_items  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve.step import build_decode_step, build_prefill  # noqa: E402

PAL = Parallel()
# fp32 logits and cache entries of magnitude ~1-5, summed in different
# orders by XLA and torch: a few ulps; 1e-5 absolute and relative
RTOL = ATOL = 1e-5
STEPS = 4
WINDOW = 8
# (case, arch, prompt length): sliding "prefill" wraps the ring buffer in
# the prefill (prompt 12 > window 8), "decode" only in the decode steps
# (prompt 6: positions 8 and 9 take slots 0 and 1)
CASES = (("granite-8b", "granite-8b", 12), ("starcoder2-7b", "starcoder2-7b",
                                            12),
         ("tied-norope", "starcoder2-7b", 12),
         ("sliding-prefill", "granite-8b", 12),
         ("sliding-decode", "granite-8b", 6))


def _cfgs(case: str, arch: str, dtype="float32"):
    out = []
    for mod in (jbase, tbase):
        cfg = dataclasses.replace(mod.reduced_config(mod.get_config(arch)),
                                  dtype=dtype)
        if case == "tied-norope":
            cfg = dataclasses.replace(cfg, tie_embeddings=True, rope=False)
        if case.startswith("sliding"):
            cfg = dataclasses.replace(cfg, attn_kind="sliding", window=WINDOW)
        out.append(cfg)
    return out


def _params(jcfg, seed=1):
    """The reference's init with the biases and norm scales moved off
    their init values by numpy noise, as numpy."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if path[-1].key in ("scale", "bias", "bq", "bk", "bv", "up_b",
                            "down_b"):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(
        move, jax.device_get(jax_init_params(jcfg, PAL,
                                             jax.random.PRNGKey(seed))))


def _tokens(batch, n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (batch, n)).astype(
        np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case,arch,prompt", CASES)
def test_prefill_and_decode_match_reference(case, arch, prompt):
    """Prefill logits and every cache leaf, then STEPS teacher-forced
    decode steps' logits and caches, against the reference; the same
    steps from the reference's prefill cache carried into the port."""
    jcfg, tcfg = _cfgs(case, arch)
    jparams = _params(jcfg)
    tparams = params_from_jax(jparams)
    tokens = _tokens(2, prompt + STEPS)
    max_seq = prompt + STEPS
    jlogits, jcache = jax.jit(lambda p, t: jax_prefill(
        p, {"tokens": t}, jcfg, PAL, max_seq=max_seq))(
            jparams, jnp.asarray(tokens[:, :prompt]))
    with torch.inference_mode():
        tlogits, tcache = tfm.prefill(
            tparams, {"tokens": torch.from_numpy(tokens[:, :prompt]).long()},
            tcfg, max_seq)
    _close(tlogits, jlogits, "prefill logits")
    jitems = tree_items(jax.device_get(jcache))
    titems = tree_items(cache_to_jax(tcache))
    assert [p for p, _ in titems] == [p for p, _ in jitems]
    for (path, got), (_, want) in zip(titems, jitems):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        _close(got, want, f"prefill cache {path}")
    if case.startswith("sliding"):
        assert tcache["blocks"]["l0"]["k"].shape[2] == WINDOW
    carried = cache_from_jax(jax.device_get(jcache))
    jdec = jax.jit(lambda p, c, t: jax_decode_step(p, c, t, jcfg, PAL))
    for i in range(STEPS):
        tok = tokens[:, prompt + i:prompt + i + 1]
        jlogits, jcache = jdec(jparams, jcache, jnp.asarray(tok))
        with torch.inference_mode():
            tlogits, tcache = tfm.decode_step(
                tparams, tcache, torch.from_numpy(tok).long(), tcfg)
            clogits, carried = tfm.decode_step(
                tparams, carried, torch.from_numpy(tok).long(), tcfg)
        _close(tlogits, jlogits, f"decode step {i} logits")
        _close(clogits, jlogits, f"decode step {i} logits (carried cache)")
    assert int(tcache["pos"]) == int(carried["pos"]) == int(jcache["pos"]) \
        == prompt + STEPS
    for (path, got), (_, want) in zip(tree_items(cache_to_jax(tcache)),
                                      tree_items(jax.device_get(jcache))):
        _close(got, want, f"decode cache {path}")


def test_bf16_cache_crosses_bit_for_bit():
    """The config's bf16 cache: the reference's prefill cache crosses into
    the port and back with every bit kept, and a port decode step from it
    writes the slot that the reference's writes: the step's k and v come
    out of two bf16 layers, whose roundings the two packages place
    differently, so they agree within 4 bf16 ulps (2^-8 each) of the
    largest entry."""
    jcfg, tcfg = _cfgs("sliding-prefill", "granite-8b", dtype="bfloat16")
    jparams = _params(jcfg)
    tokens = _tokens(2, 13)
    _, jcache = jax.jit(lambda p, t: jax_prefill(
        p, {"tokens": t}, jcfg, PAL, max_seq=13))(
            jparams, jnp.asarray(tokens[:, :12]))
    jcache = jax.device_get(jcache)
    carried = cache_from_jax(jcache)
    assert carried["blocks"]["l0"]["k"].dtype == torch.bfloat16
    for (path, got), (_, want) in zip(tree_items(cache_to_jax(carried)),
                                      tree_items(jcache)):
        assert got.dtype == want.dtype, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    _, jnext = jax.jit(lambda p, c, t: jax_decode_step(p, c, t, jcfg, PAL))(
        jparams, jcache, jnp.asarray(tokens[:, 12:]))
    with torch.inference_mode():
        _, tnext = tfm.decode_step(params_from_jax(jparams), carried,
                                   torch.from_numpy(tokens[:, 12:]).long(),
                                   tcfg)
    slot = 12 % WINDOW
    for name in ("k", "v"):
        got = tnext["blocks"]["l0"][name][:, :, slot].float().numpy()
        want = np.asarray(jnext["blocks"]["l0"][name][:, :, slot],
                          np.float32)
        assert np.abs(got - want).max() <= 4 * 2 ** -8 * np.abs(want).max()
        # the other slots are the carried cache's, untouched
        rest = [i for i in range(WINDOW) if i != slot]
        assert np.asarray(cache_to_jax(tnext)["blocks"]["l0"][name])[
            :, :, rest].tobytes() == np.asarray(
                jcache["blocks"]["l0"][name])[:, :, rest].tobytes()


def _run(arch="granite-8b", batch=2, seq=10, **kw):
    cfg = tbase.reduced_config(tbase.get_config(arch))
    return tbase.RunConfig(model=cfg, shape=tbase.ShapeConfig(
        "serve", seq, batch, "decode"), **kw)


def test_serve_step_builders_match_the_model_functions():
    """build_prefill / build_decode_step at one rank are the model's
    prefill and decode_step under inference mode, with the cache of
    ``run.shape.seq_len`` positions; ``attn_override="sliding"`` serves
    the sliding variant."""
    run = _run(attn_override="sliding")
    cfg = tbase.resolve_model_cfg(run)
    assert cfg.attn_kind == "sliding"
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens(2, 8)).long()
    pre, dec = build_prefill(run, "cpu"), build_decode_step(run, "cpu")
    logits, cache = pre(params, {"tokens": tokens[:, :6]})
    assert cache["blocks"]["l0"]["k"].shape[2] == 10
    assert cache["blocks"]["l0"]["k"].is_inference()
    with torch.inference_mode():
        want, wcache = tfm.prefill(params, {"tokens": tokens[:, :6]}, cfg,
                                   10)
    assert torch.equal(logits, want)
    for t in (6, 7):
        logits, cache = dec(params, cache, tokens[:, t:t + 1])
        with torch.inference_mode():
            want, wcache = tfm.decode_step(params, wcache, tokens[:, t:t + 1],
                                           cfg)
        assert torch.equal(logits, want)
    assert int(cache["pos"]) == 8


# the last id is the case's name from when context-parallel decode of
# MLA, an SSM or a hybrid model raised
@pytest.mark.parametrize("data,model,batch,match", [
    (2, 1, 3, "batch of 3 rows does not split over 2"),
    (4, 1, 2, "cache of 10 slots does not split over 4"),
    pytest.param(1, 2, 8, None, id="1-2-8-ROADMAP A13")])
def test_serve_step_beyond_one_rank_raises(data, model, batch, match,
                                           monkeypatch):
    """What the serve step does not serve over ``data`` ranks raises: a
    data-parallel batch that the ranks do not split and context-parallel
    decode (batch < data) of a cache whose slots they do not split (the
    reference cannot place either). Every family decodes
    context-parallel (ROADMAP A13e, done): over a data group of 2 beside
    a model group of ``model`` the decode builder of a batch of one
    builds for the dense layouts, MLA, the SSM and hybrid families, the
    encoder-decoder and the vision stub (tests/test_torch_world_cp.py
    holds the numbers). ``decode_cache_layout`` is the builders' check of
    the layout, at the group's size."""
    from repro_torch.serve import step as serve_step
    from repro_torch.serve.step import decode_cache_layout
    run = _run(batch=batch)
    if match is None:
        monkeypatch.setattr(serve_step, "world", lambda group: (data * 2, 0))
        for arch in ("granite-8b", "deepseek-v2-lite-16b", "xlstm-125m",
                     "jamba-v0.1-52b", "whisper-small",
                     "phi-3-vision-4.2b"):
            cfg = tbase.reduced_config(tbase.get_config(arch))
            one = dataclasses.replace(run, model=cfg,
                                      shape=dataclasses.replace(
                                          run.shape, global_batch=1))
            serve_step.build_decode_step(one, "cpu")
            assert serve_step.serve_parallel(one, decode=True) \
                .cache_seq_sharded
            assert decode_cache_layout(one, 2, True) == (1, 5)
        return
    with pytest.raises(ValueError, match=match):
        decode_cache_layout(run, data, batch < data)
    assert decode_cache_layout(_run(batch=8), 2, False) == (4, 10)
    assert decode_cache_layout(_run(batch=1, seq=12), 4, True) == (1, 3)


@pytest.mark.parametrize("arch", ["granite-8b", "starcoder2-7b"])
def test_serve_launcher_smoke(arch, capsys):
    """``python -m repro_torch.launch.serve --arch ARCH --smoke --device
    cpu`` in-process: the reference's printout, and the greedy tokens
    consistent with the full forward (the last step's logits within
    2e-4 of it, relative to its largest logit, as the reference's own
    prefill/decode test holds them)."""
    assert launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "prefill 8 tokens x 2:" in out
    assert "decode 4 steps:" in out and "ms/step" in out
    assert "first sequences: [[" in out
    run = launcher.run_config(launcher.parse_args(
        ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "4"]))
    params = tfm.init_params(run.model, torch.Generator().manual_seed(1),
                             "cpu")
    res = launcher.serve(run, device="cpu", prompt_len=8, new_tokens=4,
                         params=params, log=lambda msg: None)
    assert tuple(res["tokens"].shape) == (2, 4)
    assert res["params"] == run.model.param_count()
    tokens = torch.cat([res["prompt"], res["tokens"]], 1)
    with torch.inference_mode():
        full = tfm.full_logits(params, {"tokens": tokens}, run.model)
    scale = float(full.abs().max())
    assert float((res["logits"] - full[:, -1]).abs().max()) / scale < 2e-4
    assert float((res["prefill_logits"] - full[:, 7]).abs().max()) / scale \
        < 2e-4
    assert torch.equal(res["tokens"][:, 0], res["prefill_logits"].argmax(-1))


# the ids are the cases' names from when each raised naming its ROADMAP
# item (A14, A13e, A13, A13e)
@pytest.mark.parametrize("flag,item", [
    pytest.param(["--data", "2", "--apply-deltas", "spool"], None,
                 id="flag0-ROADMAP A14"),
    pytest.param(["--arch", "deepseek-v2-lite-16b", "--model", "2",
                  "--data", "2", "--batch", "1"], None,
                 id="flag1-ROADMAP A13"),
    pytest.param(["--devices", "8"], (
        "--devices: the port runs one process a rank under torchrun "
        "(--nproc-per-node with --data and --model), not a mesh of devices "
        "in one process"), id="flag2-ROADMAP A13"),
    pytest.param(["--arch", "jamba-v0.1-52b", "--model", "2", "--data", "2",
                  "--batch", "1"], None, id="flag3-ROADMAP A13")])
def test_serve_launcher_unported_flags_raise(flag, item):
    """Deltas applied over more than one rank (A14's remainder, done) and
    context-parallel decode (``--batch`` below ``--data``) of MLA or a
    hybrid model beside a model group (A13e, done) pass the launcher's
    checks; outside torchrun the launcher then refuses to run one rank
    in place of the group. ``--devices``, the reference's mesh of host
    devices in one process, is a ValueError with this full text: the
    port runs one process a rank. Every flag the launcher takes is
    served (tests/test_torch_group_delta.py, tests/test_torch_world_cp.py
    and the tensor-parallel files hold the paths)."""
    argv = ["--arch", "granite-8b", "--smoke", "--device", "cpu", *flag]
    args = launcher.parse_args(argv)
    if item is not None:
        with pytest.raises(ValueError) as err:
            launcher.check_args(args)
        assert str(err.value) == item
        with pytest.raises(ValueError) as err:
            launcher.main(argv)
        assert str(err.value) == item
        return
    launcher.check_args(args)
    with pytest.raises(RuntimeError, match="there is no process group to "
                       "join"):
        launcher.main(argv)
@pytest.mark.parametrize("flag", [
    ["--arch", "xlstm-125m", "--model", "2"],
    ["--arch", "deepseek-v2-lite-16b", "--mla-absorb", "--model", "2"],
    ["--arch", "jamba-v0.1-52b", "--model", "2"],
    ["--arch", "whisper-small", "--model", "2"],
    ["--arch", "phi-3-vision-4.2b", "--model", "2"]])
def test_serve_launcher_model_parallel_passes_the_gate(flag, monkeypatch):
    """``--model 2`` of xLSTM, absorbed MLA, the hybrid, the
    encoder-decoder and the vision stub passes the launcher's checks:
    without torchrun's environment it then finds no group to join (the
    runs themselves over gloo: tests/test_torch_tensor_parallel_ssm.py,
    tests/test_torch_tensor_parallel_encdec.py)."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launcher.main(["--smoke", "--device", "cpu", *flag])


@pytest.fixture(scope="module")
def spool(tmp_path_factory):
    """A port trainer's delta spool: 3 versions of reduced granite-8b,
    snapshots at versions 0, 2 and 3."""
    from repro_torch.launch import train as train_launcher
    root = str(tmp_path_factory.mktemp("spool"))
    train_launcher.main(["--arch", "granite-8b", "--smoke", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--publish-deltas",
                         root, "--delta-snapshot-every", "2",
                         "--device", "cpu"])
    return root


@pytest.mark.parametrize("flag,health", [
    ([], "'received': 3, 'applied': 0, 'dropped_corrupt': 0, "
         "'dropped_nonfinite': 0, 'dropped_stale': 3"),
    (["--delta-fault-schedule", "loss:0.4,seed=2"],
     "'received': 2, 'applied': 0, 'dropped_corrupt': 0, "
     "'dropped_nonfinite': 0, 'dropped_stale': 2")],
    ids=["apply_deltas", "delta_fault_schedule"])
def test_serve_launcher_delta_flags(spool, capsys, flag, health):
    """--apply-deltas (and its receive-side faults): the replica starts at
    the latest snapshot, v3, so the spool's three versions arrive stale
    (version 2 lost to the schedule), as the reference launcher's replica
    would see them."""
    assert launcher.main(["--arch", "granite-8b", "--smoke", "--device",
                          "cpu", "--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "2", "--apply-deltas", spool,
                          *flag]) == 0
    out = capsys.readouterr().out
    assert "(snapshot v3)" in out and "live params now v3" in out
    assert health in out
    assert ("(recv side): loss:0.4,seed=2" in out) == bool(flag)
    with pytest.raises(SystemExit):
        launcher.parse_args(["--arch", "granite-8b",
                             "--delta-fault-schedule", "loss:0.1"])
