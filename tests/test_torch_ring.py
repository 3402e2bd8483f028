"""Ring attention (``attn_dist="ring"``, the reference's ``_ring_fwd``,
reached through ``build_parallel(mesh, attn_dist="ring")``) in the port
against the reference's ``shard_map`` programs on meshes of host CPU
devices (tests/jax_mesh_worker.py's mode "tp", two subprocesses side by
side), the port's ranks over gloo (tests/torch_gloo_worker.py's modes
"collectives", "tp_train" and "ring_equal"):

- ``ppermute_model`` by +1 and -1: every rank's output and gradient
  against ``jax.vjp`` of the reference's ``ppermute_model`` under
  ``shard_map(check_vma=False)`` (its transpose is the inverse shift),
  bitwise;
- training with ring attention: reduced StableLM-3B (full attention on
  (1, 4) and (2, 2), a sliding window of 8 over blocks of 8 on (1, 4)),
  reduced DeepSeek-V2-Lite (MLA: the compressed ckv and krope rotate and
  each rank expands them with its own uk and uv) on (1, 4) and (2, 2),
  and reduced Whisper-small (the encoder's ring over blocks of the whole
  frames, the decoder's cross-attention summed over the ranks' full
  heads) on (1, 4) and (2, 2); REGTOP-k fused with sparse comm, Adam, 3
  steps from the reference's initial parameters (each rank's attention
  weights its own draw): tests/test_torch_tensor_parallel.py's
  ``check_train``;
- with every model rank's attention weights set to one device's, the
  ring's loss (the model group's sum of the shares) equals that
  device's loss to rtol 1e-5, in both packages (reduced StableLM full
  and sliding, reduced DeepSeek-V2-Lite with its MoE at capacity factor
  16 without the load-balance term), and the port's one-device loss the
  reference's.

Ranks meet through a ``file://`` rendezvous under tmp_path."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_threads import one_thread  # noqa: E402,F401
import test_torch_tensor_parallel as tpt  # noqa: E402
import test_torch_tensor_parallel_encdec as tpe  # noqa: E402
import test_torch_tensor_parallel_ssm as tps  # noqa: E402

RING = dict(attn_dist="ring", sparsifier=tpt.MAIN)
WINDOW = 8
TRAIN = {
    "stablelm_ring_1x4": dict(arch="stablelm-3b", mesh=[1, 4], **RING),
    "stablelm_ring_2x2": dict(arch="stablelm-3b", mesh=[2, 2], **RING),
    "sliding_ring_1x4": dict(arch="stablelm-3b", mesh=[1, 4], attn="sliding",
                             window=WINDOW, **RING),
    "mla_ring_1x4": dict(arch="deepseek-v2-lite-16b", mesh=[1, 4], **RING),
    "mla_ring_2x2": dict(arch="deepseek-v2-lite-16b", mesh=[2, 2], **RING),
    "whisper_ring_1x4": dict(arch="whisper-small", mesh=[1, 4], **RING),
    "whisper_ring_2x2": dict(arch="whisper-small", mesh=[2, 2], **RING),
}
EQUAL = {
    "stablelm_equal": dict(arch="stablelm-3b", mesh=[1, 4]),
    "sliding_equal": dict(arch="stablelm-3b", mesh=[1, 4], attn="sliding",
                          window=WINDOW),
    "mla_equal": dict(arch="deepseek-v2-lite-16b", mesh=[1, 4]),
}
EQUAL_RTOL = 1e-5
PERMUTES = ("ppermute", "ppermute_back")


def _collective_inputs() -> dict:
    inp = tpt._inputs()
    rng = np.random.default_rng(29)
    return dict(x=inp["x"], **{f"ct_{name}": rng.standard_normal(
        inp["x"].shape).astype(np.float32) for name in PERMUTES})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ppermutes and ring_equal cases in one process, its
    ring train cases in another, each of 4 devices."""
    inp = tpe.train_inputs()
    return tps._run_reference(tmp_path_factory.mktemp("reference"), {
        "equal": dict(tokens=inp["tokens"], targets=inp["targets"],
                      ring_cases=json.dumps(EQUAL), **_collective_inputs()),
        "train": dict(steps=tpt.STEPS, train_cases=json.dumps(TRAIN),
                      **inp)})


@pytest.fixture(scope="module")
def trained(tmp_path_factory, reference):
    init = {key: val for key, val in reference.items()
            if any(key.startswith(f"{name}_init/") for name in TRAIN)}
    return tpt._spawn_ranks(tmp_path_factory.mktemp("train"), "tp_train", 4,
                            steps=tpt.STEPS, cases=json.dumps(TRAIN),
                            **tpe.train_inputs(), **init)


@pytest.fixture(scope="module")
def equal(tmp_path_factory, reference):
    inp = tpe.train_inputs()
    one = {key: val for key, val in reference.items()
           if any(key.startswith(f"{name}_one/") for name in EQUAL)}
    return tpt._spawn_ranks(tmp_path_factory.mktemp("equal"), "ring_equal", 4,
                            tokens=inp["tokens"], targets=inp["targets"],
                            cases=json.dumps(EQUAL), **one)


@pytest.fixture(scope="module")
def permuted(tmp_path_factory):
    return tpt._spawn_ranks(tmp_path_factory.mktemp("coll"), "collectives",
                            4, **_collective_inputs())


@pytest.mark.parametrize("name", PERMUTES)
def test_ppermute_matches_the_reference(permuted, reference, name):
    """Every rank's output and gradient bitwise (data moves, nothing is
    summed); by +1 rank r holds rank r - 1's x and sends its gradient
    back."""
    x = _collective_inputs()["x"]
    shift = 1 if name == "ppermute" else -1
    for r, res in enumerate(permuted):
        assert not bool(res["jax_imported"])
        for key in ("y", "gx"):
            assert np.array_equal(res[f"{name}_{key}"],
                                  reference[f"{name}_{key}"][r]), (key, r)
        assert np.array_equal(res[f"{name}_y"], x[(r - shift) % 4])


@pytest.mark.parametrize("name", list(TRAIN))
def test_ring_train_matches_the_reference(trained, reference, name):
    tpt.check_train(trained, reference, name, TRAIN)


@pytest.mark.parametrize("name", list(EQUAL))
def test_ring_equals_one_device_with_equal_weights(equal, reference, name):
    """With the attention weights equal across the model ranks, ring
    attention is the whole sequence's attention: the ring loss equals one
    device's in each package, and the port's one-device loss the
    reference's."""
    want = float(reference[f"{name}_one_loss"])
    np.testing.assert_allclose(float(reference[f"{name}_ring_loss"]), want,
                               rtol=EQUAL_RTOL)
    for res in equal:
        assert not bool(res["jax_imported"])
        np.testing.assert_allclose(float(res[f"{name}_one_loss"]), want,
                                   rtol=EQUAL_RTOL)
        np.testing.assert_allclose(float(res[f"{name}_ring_loss"]),
                                   float(res[f"{name}_one_loss"]),
                                   rtol=EQUAL_RTOL)


def test_ring_gives_every_rank_all_heads():
    """Under ring attention every rank holds all the heads (no padding,
    nothing masked), in its share of the other leaves; an unknown
    ``attn_dist`` is a ValueError; at tp 1 ring is off."""
    from repro_torch.configs import base as tbase
    from repro_torch.models import attention, init_params
    from repro_torch.models.parallel import Parallel, ring_on

    class Ring(Parallel):
        tp, tp_on, model_rank = 4, True, 1

    cfg = tbase.reduced_config(tbase.get_config("whisper-small"))
    ring, sp = Ring(attn_dist="ring"), Ring()
    assert ring_on(ring) and not ring_on(sp)
    assert not ring_on(Parallel(attn_dist="ring"))
    assert attention.head_counts(cfg, ring) == (cfg.n_heads, cfg.n_kv_heads)
    assert attention.head_counts(cfg, sp) == (1, 1)
    o = torch.ones(1, 2, cfg.n_heads, 3)
    assert attention.mask_padded_heads(o, cfg, ring) is o
    p = init_params(cfg, torch.Generator(), "meta", ring)
    hd = cfg.resolved_head_dim
    for tree in (p["blocks"]["l0"]["attn"], p["blocks"]["l0"]["cross"],
                 p["encoder"]["blocks"]["attn"]):
        assert tree["wq"].shape[-1] == cfg.n_heads * hd
    assert p["blocks"]["l0"]["mlp"]["up"].shape[-1] == cfg.d_ff // 4
    with pytest.raises(ValueError, match="attn_dist"):
        Parallel(attn_dist="context")
