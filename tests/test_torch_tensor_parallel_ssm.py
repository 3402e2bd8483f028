"""Tensor parallelism of MLA, of Mamba with the Jamba hybrid and of xLSTM
in the port against the reference's ``shard_map`` programs on meshes of
host CPU devices (tests/jax_mesh_worker.py's mode "tp", the train and
serve cases in two subprocesses side by side), the port's ranks over
gloo (tests/torch_gloo_worker.py's modes "tp_train" and "tp_serve"):

- the parameter split rules and local shapes against the reference's
  ``param_specs``, ``replicated_mask`` and ``init_params`` for reduced
  DeepSeek-V2-Lite-16B (MLA: wq, uk and uv by head, dkv and kv_norm
  replicated), Jamba-v0.1-52B (Mamba by channel) and xLSTM-125M (the
  mLSTM's value dims, the sLSTM's channels) at tp 4 and 2
  (tests/test_torch_tensor_parallel.py's ``test_param_specs_*``);
- ``convert``'s split and join of their parameters and decode caches,
  bitwise, and ``cache_split_dims`` by leaf;
- training: each of the three reduced models, REGTOP-k fused with
  sparse comm, Adam, 3 steps from the reference's initial parameters
  on (1, 4) and (2, 2) meshes, and DeepSeek with 6 query and 2
  key/value heads on (1, 4) (MLA's heads padded to 8): every step's
  loss, ``gnorm_local``, ``agg_nonzero`` and aux terms (the group
  means) to rtol 1e-5 on every rank, each rank's sorted ``idx_prev``
  bitwise, the parameters gathered into the global layout to atol
  1e-5, each rank's copy of the replicated leaves against the same
  device's copy in the reference, and the parameters bitwise across
  each data pair (tests/test_torch_tensor_parallel.py's tolerances),
  up to a REGTOP-k selection flip at a near-tie, whose step and size
  ``check_train(flips=True)`` bounds (``FLIP_ENTRIES``: from it on the
  metrics to rtol 1e-3 and the parameters to 2e-3 a step);
- serving on (1, 4): DeepSeek with MLA expanded and absorbed, Jamba
  and xLSTM: the prefill's and 4 teacher-forced decode steps' logits
  (the padded vocabulary's) and each rank's cache, leaf by leaf,
  against the same device's shard of the reference's cache, to rtol =
  atol = 1e-5 (tests/test_torch_serve.py's).

Ranks meet through a ``file://`` rendezvous under tmp_path."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_threads import one_thread  # noqa: E402,F401
import test_torch_tensor_parallel as tpt  # noqa: E402

MAIN = tpt.MAIN
TRAIN = {
    "deepseek_1x4": dict(arch="deepseek-v2-lite-16b", mesh=[1, 4],
                         sparsifier=MAIN),
    "deepseek_2x2": dict(arch="deepseek-v2-lite-16b", mesh=[2, 2],
                         sparsifier=MAIN),
    "mla_padded_1x4": dict(arch="deepseek-v2-lite-16b", mesh=[1, 4],
                           heads=[6, 2], sparsifier=MAIN),
    "jamba_1x4": dict(arch="jamba-v0.1-52b", mesh=[1, 4], sparsifier=MAIN),
    "jamba_2x2": dict(arch="jamba-v0.1-52b", mesh=[2, 2], sparsifier=MAIN),
    "xlstm_1x4": dict(arch="xlstm-125m", mesh=[1, 4], sparsifier=MAIN),
    "xlstm_2x2": dict(arch="xlstm-125m", mesh=[2, 2], sparsifier=MAIN),
}
SERVE = {
    "mla_expanded_1x4": dict(arch="deepseek-v2-lite-16b", mesh=[1, 4]),
    "mla_absorbed_1x4": dict(arch="deepseek-v2-lite-16b", mesh=[1, 4],
                             absorb=True),
    "jamba_serve_1x4": dict(arch="jamba-v0.1-52b", mesh=[1, 4]),
    "xlstm_serve_1x4": dict(arch="xlstm-125m", mesh=[1, 4]),
}
for _case in SERVE.values():
    _case.update(batch=4, prompt=tpt.PROMPT, seq=tpt.SERVE_SEQ)


def _run_reference(tmp, parts: dict) -> dict:
    """Each part's reference run (mode "tp" over 4 host devices) in a
    process of its own, side by side; their outputs merged."""
    procs = {}
    for name, data in parts.items():
        np.savez(tmp / f"{name}_in.npz", mode="tp", **data)
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(tpt.HERE, "jax_mesh_worker.py"),
             "4", str(tmp / f"{name}_in.npz"), str(tmp / f"{name}_out.npz")],
            env=tpt._env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    try:
        logs = {name: p.communicate(timeout=900)[0]
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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's train cases and serve cases, in two processes of 4
    devices each."""
    inp = tpt._inputs()
    return _run_reference(tmp_path_factory.mktemp("reference"), {
        "serve": dict(window=tpt.WINDOW, serve_cases=json.dumps(SERVE),
                      serve_tokens=inp["serve_tokens"].astype(np.int32)),
        "train": dict(tokens=inp["tokens"], targets=inp["targets"],
                      steps=tpt.STEPS, train_cases=json.dumps(TRAIN))})


@pytest.fixture(scope="module")
def trained(tmp_path_factory, reference):
    inp = tpt._inputs()
    init = {key: val for key, val in reference.items()
            if any(key.startswith(f"{name}_init/") for name in TRAIN)}
    return tpt._spawn_ranks(tmp_path_factory.mktemp("train"), "tp_train", 4,
                            tokens=inp["tokens"], targets=inp["targets"],
                            steps=tpt.STEPS, cases=json.dumps(TRAIN), **init)


@pytest.fixture(scope="module")
def served(tmp_path_factory, reference):
    inp = tpt._inputs()
    keep = {key: val for key, val in reference.items()
            if any(key.startswith(f"{name}_init/")
                   or key.startswith(f"{name}_shard") for name in SERVE)}
    return tpt._spawn_ranks(tmp_path_factory.mktemp("serve"), "tp_serve", 4,
                            tokens=inp["serve_tokens"], window=tpt.WINDOW,
                            cases=json.dumps(SERVE), **keep)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_matches_the_reference(trained, reference, name):
    tpt.check_train(trained, reference, name, TRAIN, flips=True)


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_matches_the_reference(served, reference, name):
    tpt.check_serve(served, reference, name)


def _tree(reference, prefix):
    from repro_torch.core.flatten import tree_from_items
    return tree_from_items(
        (tuple(int(k) if k.isdigit() else k for k in key.split("/")), val)
        for key, val in tpt._by_path(reference, prefix).items())


@pytest.mark.parametrize("name", ["deepseek_1x4_init", "mla_padded_1x4_init",
                                  "jamba_1x4_init", "xlstm_1x4_init",
                                  "mla_expanded_1x4_cache",
                                  "jamba_serve_1x4_cache",
                                  "xlstm_serve_1x4_cache"])
def test_convert_split_and_join_round_trip(reference, name):
    """``split_params`` then ``join_params`` (or ``split_cache`` then
    ``join_cache``) gives the reference's global tree back bit for bit,
    at tp 4 and 2; a replicated leaf is the same on every rank."""
    from repro_torch.convert import (join_cache, join_params, split_cache,
                                     split_params)
    from repro_torch.core.flatten import tree_items
    from repro_torch.models.specs import leaf_dim
    split, join = (split_params, join_params) if name.endswith("_init") \
        else (split_cache, join_cache)
    glob = _tree(reference, name)
    for tp in (4, 2):
        parts = [split(glob, tp, r) for r in range(tp)]
        for (p, a), (_, b) in zip(tree_items(glob),
                                  tree_items(join(parts))):
            assert np.array_equal(a, b), (tp, p)
        if split is split_params:
            for i, (path, leaf) in enumerate(tree_items(glob)):
                if leaf_dim(path, np.ndim(leaf)) is None:
                    for part in parts[1:]:
                        assert np.array_equal(tree_items(part)[i][1], leaf)


def test_cache_split_dims_by_leaf():
    """Which dimension of each decode cache leaf the model group splits:
    Mamba's conv and h and the sLSTM's c, n and m by channel, the
    mLSTM's c by value dim with n and m whole, attention's k and v by
    head, MLA's ckv and krope and ``pos`` whole; a local cache drawn at tp
    4 has those dims a quarter of the one-rank cache's."""
    from repro_torch.configs import base as tbase
    from repro_torch.convert import cache_split_dims
    from repro_torch.core.flatten import tree_items
    from repro_torch.models import transformer as tfm
    want = {"conv": -1, "h": -2, "k": -2, "v": -2, "ckv": None,
            "krope": None, "pos": None}
    for arch in ("jamba-v0.1-52b", "xlstm-125m", "deepseek-v2-lite-16b"):
        cfg = tbase.reduced_config(tbase.get_config(arch))
        one = tfm.init_decode_cache(cfg, 2, 16, torch.float32, "meta")
        local = tfm.init_decode_cache(cfg, 2, 16, torch.float32, "meta",
                                      tpt._Model(4))
        dims = cache_split_dims(one)
        assert [p for p, _ in dims] == [p for p, _ in
                                        cache_split_dims(local)]
        for (path, leaf), (_, small), (_, dim) in zip(
                tree_items(one), tree_items(local), dims):
            name = path[-1]
            if name in want:
                exp = want[name]
            elif tbase.layer_pattern(cfg)[int(path[1][1:])][0] == "mlstm":
                exp = -2 if name == "c" else None
            else:
                exp = -1
            exp = None if exp is None else exp % leaf.ndim
            assert dim == exp, (arch, path)
            shape = list(leaf.shape)
            if dim is not None:
                shape[dim] //= 4
            assert list(small.shape) == shape, (arch, path)
