"""Tensor and expert parallelism of the port against the reference's
``shard_map`` programs on meshes of host CPU devices
(tests/jax_mesh_worker.py's mode "tp", two subprocesses for the
module, side by side),
the port's ranks over gloo (tests/torch_gloo_worker.py):

- each model-group collective (psum, the tiled all_gather and
  psum_scatter, the MoE's all_to_all, the cross-entropy's stop-gradient
  pmax): every rank's output and its gradient against ``jax.vjp`` of the
  reference's collective under ``shard_map(check_vma=False)`` (psum
  transposes to psum, all_gather to psum_scatter and back, all_to_all
  to its inverse);
- the parameter split rules (``models.specs``) and the local shapes
  against the reference's ``param_specs``, ``replicated_mask`` and
  ``init_params`` on every in-slice arch's reduced config at tp 4 and
  2; ``convert``'s split and join of parameters and caches bitwise;
- training: reduced StableLM-3B and reduced Granite-MoE-3B-A800M,
  REGTOP-k fused with sparse comm, Adam, 3 steps from the reference's
  initial parameters, on (1, 4) and (2, 2) meshes, and StableLM with 6
  query and 2 key/value heads and a vocabulary of 510 on (1, 4) (the
  heads padded to 8 and 4, the vocabulary to 512), and StableLM on (2,
  2) streamed behind the backward pass with the global norm clipped:
  the loss,
  ``gnorm_local``, ``agg_nonzero`` and the aux terms to rtol 1e-5 on
  every rank, each rank's sorted ``idx_prev`` bitwise, the parameters
  gathered into the global layout to atol 1e-5
  (tests/test_torch_world_train.py's tolerances), and each rank's copy
  of the replicated leaves against the same device's copy in the
  reference (the copies need not agree across the model group: each
  rank's REGTOP-k selects its entries of them on its own threshold, in
  both packages);
- serving: reduced Granite-8B (full, and sliding with a window of 8 that
  the decode wraps) on (2, 2) and (1, 4), reduced Granite-MoE on (1,
  4): the prefill's and 4 teacher-forced decode steps' logits (the
  padded vocabulary's) and each rank's cache (the same device's shard of
  the reference's: its rows and key/value heads) to
  tests/test_torch_serve.py's rtol = atol = 1e-5;
- both launchers' ``main()`` with ``--model 2`` over a gloo world of 2.

MLA, Mamba with the Jamba hybrid and xLSTM under tensor parallelism are
held in tests/test_torch_tensor_parallel_ssm.py, the encoder-decoder and
the vision stub in tests/test_torch_tensor_parallel_encdec.py, ring
attention in tests/test_torch_ring.py and checkpoints and deltas over a
model group in tests/test_torch_tp_checkpoint.py, each with this file's
helpers. Ranks meet through a ``file://`` rendezvous under tmp_path."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS, BATCH, SEQ = 3, 8, 32
RTOL = 1e-5                 # tests/test_torch_train.py's
PARAM_ATOL = 1e-5
SERVE_TOL = 1e-5            # tests/test_torch_serve.py's
MAIN = dict(kind="regtopk", sparsity=0.01, mu=0.5, pipeline="fused",
            comm_mode="sparse")
TRAIN = {
    "stablelm_1x4": dict(arch="stablelm-3b", mesh=[1, 4], sparsifier=MAIN),
    "stablelm_2x2": dict(arch="stablelm-3b", mesh=[2, 2], sparsifier=MAIN),
    "moe_1x4": dict(arch="granite-moe-3b-a800m", mesh=[1, 4],
                    sparsifier=MAIN),
    "moe_2x2": dict(arch="granite-moe-3b-a800m", mesh=[2, 2],
                    sparsifier=MAIN),
    "padded_1x4": dict(arch="stablelm-3b", mesh=[1, 4], heads=[6, 2],
                       vocab=510, sparsifier=MAIN),
    # the streamed step (a replicated leaf's gradient summed in its hook)
    # and the clipped global norm (replicated leaves weighed 1/tp)
    "streamed_clipped_2x2": dict(arch="stablelm-3b", mesh=[2, 2],
                                 sparsifier=dict(MAIN, overlap="backward"),
                                 optimizer=dict(grad_clip=0.01)),
}
WINDOW, PROMPT, SERVE_SEQ, DECODE = 8, 6, 16, 4
SERVE = {
    "granite_full_2x2": dict(arch="granite-8b", attn="full", mesh=[2, 2]),
    "granite_full_1x4": dict(arch="granite-8b", attn="full", mesh=[1, 4]),
    "granite_sliding_2x2": dict(arch="granite-8b", attn="sliding",
                                mesh=[2, 2]),
    "granite_sliding_1x4": dict(arch="granite-8b", attn="sliding",
                                mesh=[1, 4]),
    "moe_serve_1x4": dict(arch="granite-moe-3b-a800m", attn="full",
                          mesh=[1, 4]),
}
for _case in SERVE.values():
    _case.update(batch=4, prompt=PROMPT, seq=SERVE_SEQ)
# each rank's x (8, 4, 3) and the shape of each collective's output
COLLECTIVES = {"psum": (8, 4, 3), "all_gather": (8, 16, 3),
               "psum_scatter": (8, 1, 3), "all_to_all": (2, 16, 3),
               "pmax": (8, 4, 3)}
METRICS = ("loss", "gnorm_local", "agg_nonzero", "lb_loss", "z_loss",
           "drop_frac")


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), os.path.join(HERE, "..")]),
        OMP_NUM_THREADS="1")


def _inputs() -> dict:
    rng = np.random.default_rng(28)
    tokens = rng.integers(0, 510, (BATCH, SEQ)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], -np.ones((BATCH, 1),
                                                      np.int32)], 1)
    data = {"x": rng.standard_normal((4, 8, 4, 3)).astype(np.float32),
            "tokens": tokens, "targets": targets, "steps": STEPS,
            "serve_tokens": rng.integers(0, 510, (4, PROMPT + DECODE)),
            "window": WINDOW}
    for name, shape in COLLECTIVES.items():
        data[f"ct_{name}"] = rng.standard_normal((4,) + shape).astype(
            np.float32)
    return data


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's collectives and serve cases, and its train cases,
    in two processes of 4 devices each, side by side."""
    tmp = tmp_path_factory.mktemp("reference")
    inp = _inputs()
    parts = {"serve": dict(
        x=inp["x"], **{k: v for k, v in inp.items() if k.startswith("ct_")},
        window=WINDOW, serve_cases=json.dumps(SERVE),
        serve_tokens=inp["serve_tokens"].astype(np.int32)),
        "train": dict(tokens=inp["tokens"], targets=inp["targets"],
                      steps=STEPS, train_cases=json.dumps(TRAIN))}
    procs = {}
    for name, data in parts.items():
        np.savez(tmp / f"{name}_in.npz", mode="tp", **data)
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "jax_mesh_worker.py"), "4",
             str(tmp / f"{name}_in.npz"), str(tmp / f"{name}_out.npz")],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    try:
        logs = {name: p.communicate(timeout=600)[0]
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for name, p in procs.items():
        assert p.returncode == 0, logs[name]
        out.update(np.load(tmp / f"{name}_out.npz"))
    return out


def _spawn_ranks(tmp, mode, world, **data):
    inp = tmp / f"{mode}{world}.npz"
    np.savez(inp, **data)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"), mode,
         str(r), str(world), str(tmp / f"rendezvous_{mode}{world}"),
         str(inp), str(tmp / f"{mode}{world}_rank{r}.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp / f"{mode}{world}_rank{r}.npz"))
            for r in range(world)]


def _by_path(reference, prefix: str) -> dict:
    return {key[len(prefix) + 1:]: val for key, val in reference.items()
            if key.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    inp = _inputs()
    return _spawn_ranks(tmp_path_factory.mktemp("coll"), "collectives", 4,
                        x=inp["x"], **{k: v for k, v in inp.items()
                                       if k.startswith("ct_")})


@pytest.fixture(scope="module")
def trained(tmp_path_factory, reference):
    inp = _inputs()
    init = {key: val for key, val in reference.items()
            if any(key.startswith(f"{name}_init/") for name in TRAIN)}
    return _spawn_ranks(tmp_path_factory.mktemp("train"), "tp_train", 4,
                        tokens=inp["tokens"], targets=inp["targets"],
                        steps=STEPS, cases=json.dumps(TRAIN), **init)


@pytest.fixture(scope="module")
def served(tmp_path_factory, reference):
    inp = _inputs()
    keep = {key: val for key, val in reference.items()
            if any(key.startswith(f"{name}_init/")
                   or key.startswith(f"{name}_shard") for name in SERVE)}
    return _spawn_ranks(tmp_path_factory.mktemp("serve"), "tp_serve", 4,
                        tokens=inp["serve_tokens"], window=WINDOW,
                        cases=json.dumps(SERVE), **keep)


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collectives_match_the_reference(collectives, reference, name):
    """Every rank's output and gradient; the data movements bitwise, the
    sums (in rank order here, in XLA's order there) to 1 ulp."""
    for r, res in enumerate(collectives):
        assert not bool(res["jax_imported"])
        for key in ("y", "gx"):
            got, want = res[f"{name}_{key}"], reference[f"{name}_{key}"][r]
            assert got.shape == want.shape, (key, got.shape, want.shape)
            if name in ("all_gather", "all_to_all") or (
                    name == "psum_scatter" and key == "gx"):
                assert np.array_equal(got, want), (name, key, r)
            else:
                np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-7,
                                           err_msg=f"{name} {key} rank {r}")
    if name == "pmax":           # no gradient through the max
        x, ct = _inputs()["x"], _inputs()["ct_pmax"]
        np.testing.assert_array_equal(collectives[0]["pmax_gx"],
                                      ct[0] * x.max(0))


class _Model:
    """A model axis of ``tp`` ranks without a process group, for shapes
    only (the fields ``models`` reads of a ``Parallel``)."""

    def __init__(self, tp: int):
        self.tp, self.tp_on, self.model_rank = tp, tp > 1, 0
        self.sp = self.seq_parallel = self.cache_seq_sharded = False


IN_SLICE = ["stablelm-3b", "granite-8b", "qwen1.5-32b", "starcoder2-7b",
            "granite-moe-3b-a800m", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
            "xlstm-125m", "whisper-small", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", IN_SLICE)
def test_param_specs_match_the_reference(arch, tp):
    """The port's split rules, replicated mask and local shapes equal
    the reference's ``param_specs``, ``replicated_mask`` and its
    ``init_params`` under a model axis of tp, leaf by leaf (with 6 query
    and 2 key/value heads, so that tp 4 pads them; xLSTM keeps its 4
    mLSTM heads, whose head dim tp splits)."""
    from repro.configs import base as jbase
    from repro.models import init_params as jinit
    from repro.models.parallel import Parallel as JParallel
    from repro.models.specs import param_specs, replicated_mask
    from repro_torch.configs import base as tbase
    from repro_torch.core.flatten import tree_items
    from repro_torch.models import init_params
    from repro_torch.models.specs import leaf_dim
    from repro_torch.models.specs import replicated_mask as trep
    heads = {} if arch == "xlstm-125m" else dict(n_heads=6, n_kv_heads=2)
    jcfg = dataclasses.replace(jbase.reduced_config(jbase.get_config(arch)),
                               **heads)
    tcfg = dataclasses.replace(tbase.reduced_config(tbase.get_config(arch)),
                               **heads)
    jtree = jax.eval_shape(lambda k: jinit(jcfg, JParallel(
        model_axis="model", tp=tp), k), jax.random.PRNGKey(0))
    ttree = init_params(tcfg, torch.Generator(), "meta", _Model(tp))
    jspecs = jax.tree_util.tree_leaves_with_path(
        param_specs(jtree), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    jleaves = jax.tree_util.tree_leaves(jtree)
    jmask = jax.tree_util.tree_leaves(replicated_mask(jtree))
    titems = tree_items(ttree)
    tmask = [m for _, m in tree_items(trep(ttree))]
    assert len(titems) == len(jleaves) == len(jspecs)
    for (path, leaf), (_, spec), jleaf, jm, tm in zip(
            titems, jspecs, jleaves, jmask, tmask):
        want = next((i for i, a in enumerate(spec) if a == "model"), None)
        assert leaf_dim(path, leaf.ndim) == want, path
        assert tuple(leaf.shape) == tuple(jleaf.shape), path
        assert tm == bool(jm), path


def test_convert_split_and_join_round_trip(reference):
    """``split_params`` then ``join_params`` gives the reference's global
    tree back bit for bit (tp 4 and 2); ``split_cache`` and
    ``join_cache`` likewise for a decode cache; a replicated leaf is the
    same on every rank."""
    from repro_torch.convert import (join_cache, join_params, split_cache,
                                     split_params)
    from repro_torch.core.flatten import tree_from_items, tree_items

    def tree(prefix):
        return tree_from_items(
            (tuple(key.split("/")), val)
            for key, val in _by_path(reference, prefix).items())
    for name, split, join in (("padded_1x4_init", split_params, join_params),
                              ("moe_serve_1x4_cache", split_cache, join_cache)):
        glob = tree(name)
        for tp in (4, 2):
            parts = [split(glob, tp, r) for r in range(tp)]
            back = join(parts)
            for (p, a), (_, b) in zip(tree_items(glob), tree_items(back)):
                assert np.array_equal(a, b), p
    parts = [split_params(tree("moe_1x4_init"), 4, r) for r in range(4)]
    router = [p["blocks"]["l0"]["moe"]["router"] for p in parts]
    assert all(np.array_equal(router[0], x) for x in router)
    assert parts[1]["blocks"]["l0"]["moe"]["gate"].shape[1] == 1


# A REGTOP-k selection flip: where a rank's threshold falls between two
# scores closer than the packages' gradients differ (2-3 ulps; up to 3e-6
# on entries of ~1 of the token table, whose rows sum the rows of
# repeated tokens), the port and the reference select one entry
# differently, and from that step on the parameters part at the entries
# it touches. With ``flips``, check_train finds the first step at which a
# rank's selection differs and holds: everything before it as without
# flips; at it at most FLIP_ENTRIES entries a rank on either side, and
# the metrics, which precede its selection, to RTOL; after it the
# metrics to FLIP_RTOL and the parameters (the replicated leaves' copies
# too) to FLIP_ATOL a step after the flip, as Adam moves an entry by
# about lr a step (1e-3; measured on the reduced MLA and xLSTM cases:
# 1.3e-3 two steps after a one-entry flip, the loss 1.9e-5 off).
FLIP_ENTRIES = 2
FLIP_RTOL = 1e-3
FLIP_ATOL = 2e-3


def _ref_idx(reference, key: str, r: int, model: int):
    return np.sort(reference[key][r // model, r % model].reshape(-1))


def first_flip(trained, reference, name: str, model: int) -> int:
    """The first step at which some rank's selection (its sorted
    ``idx_prev``) differs from the same device's in the reference; STEPS
    when none does."""
    for t in range(STEPS):
        key = f"{name}_idx_prev_{t}"
        if any(not np.array_equal(res[key], _ref_idx(reference, key, r,
                                                     model))
               for r, res in enumerate(trained)):
            return t
    return STEPS


def check_train(trained, reference, name: str, cases: dict,
                flips: bool = False) -> None:
    """A train case's metrics, ``idx_prev``, replicated leaves and final
    parameters on every rank against the reference's (with ``flips``,
    up to a selection flip's consequences: see FLIP_ENTRIES)."""
    data_n, model = cases[name]["mesh"]
    flip = first_flip(trained, reference, name, model) if flips else STEPS
    for t in range(STEPS):
        for key in METRICS:
            want = float(reference[f"{name}_{key}_{t}"])
            for r, res in enumerate(trained):
                got = res[f"{name}_{key}_{t}"]
                assert got == trained[0][f"{name}_{key}_{t}"], (key, t, r)
                np.testing.assert_allclose(
                    float(got), want, rtol=RTOL if t <= flip else FLIP_RTOL,
                    atol=1e-7, err_msg=f"{key} step {t}")
    atol = PARAM_ATOL
    if flip < STEPS:
        key = f"{name}_idx_prev_{flip}"
        for r, res in enumerate(trained):
            got, want = set(res[key].tolist()), set(
                _ref_idx(reference, key, r, model).tolist())
            assert max(len(got - want), len(want - got)) <= FLIP_ENTRIES, (
                flip, r, sorted(got ^ want))
        atol = FLIP_ATOL * (STEPS - flip)
    for r, res in enumerate(trained):
        assert not bool(res["jax_imported"])
        np.testing.assert_allclose(res[f"{name}_replicated"],
                                   reference[f"{name}_replicated"][r],
                                   rtol=0, atol=atol)
        if flip == STEPS:
            assert np.array_equal(res[f"{name}_idx_prev"], _ref_idx(
                reference, f"{name}_idx_prev", r, model)), r
    np.testing.assert_allclose(trained[0][f"{name}_params"],
                               reference[f"{name}_params"], rtol=0,
                               atol=atol)
    if data_n > 1:               # the data pair trains the same parameters
        for r in range(1, len(trained)):
            assert np.array_equal(trained[r][f"{name}_params"],
                                  trained[0][f"{name}_params"]), r


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_matches_the_reference(trained, reference, name):
    check_train(trained, reference, name, TRAIN)


def check_serve(served, reference, name: str) -> None:
    """A serve case's logits on every rank and each rank's cache against
    the same device's shard of the reference's."""
    for r, res in enumerate(served):
        assert not bool(res["jax_imported"])
        keys = ["prefill"] + [f"decode_{t}" for t in range(DECODE)]
        for key in keys:
            got, want = res[f"{name}_{key}"], reference[f"{name}_{key}"]
            assert got.shape == want.shape, (key, got.shape)
            np.testing.assert_allclose(got, want, rtol=SERVE_TOL,
                                       atol=SERVE_TOL,
                                       err_msg=f"{key} rank {r}")
        caches = [key for key in res if key.startswith(f"{name}_cache_")]
        assert caches
        for key in caches:
            np.testing.assert_allclose(
                res[key], res[key.replace("_cache_", "_want_")],
                rtol=SERVE_TOL, atol=SERVE_TOL, err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_matches_the_reference(served, reference, name):
    check_serve(served, reference, name)


LAUNCH = ["--smoke", "--device", "cpu", "--model", "2"]


def test_launchers_model_parallel_over_gloo(tmp_path):
    """``main()`` of both launchers with ``--model 2`` inside a gloo
    group of 2: the train launcher's loss (the model group's sum of the
    shares) is the same on both ranks, finite and falling on a fixed
    batch; the serve launcher's greedy tokens are the same on both
    ranks and lie in the vocabulary."""
    ranks = _spawn_ranks(
        tmp_path, "tp_launch", 2,
        train_flags=np.asarray(LAUNCH + [
            "--arch", "granite-moe-3b-a800m", "--steps", "4", "--batch",
            "4", "--seq", "16", "--comm", "sparse", "--pipeline", "fused",
            "--fixed-batch", "--log-every", "1"]),
        serve_flags=np.asarray(LAUNCH + [
            "--arch", "granite-8b", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "4"]))
    for res in ranks:
        assert not bool(res["jax_imported"])
        assert np.array_equal(res["losses"], ranks[0]["losses"])
        assert np.array_equal(res["tokens"], ranks[0]["tokens"])
    losses = ranks[0]["losses"]
    assert losses.shape == (4,) and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert ranks[0]["tokens"].shape == (2, 4)
    assert ranks[0]["tokens"].max() < 512
