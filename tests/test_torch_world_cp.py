"""Context-parallel decode of MLA, of the hybrid (Mamba beside attention)
and of the SSM family (xLSTM) in the port over gloo process groups
(tests/torch_gloo_worker.py's mode "cp_serve", one spawned group of 4
ranks) against the reference (tests/jax_mesh_worker.py's mode "cp", one
subprocess of 4 host devices): reduced DeepSeek-V2-Lite-16B with MLA
expanded and absorbed, reduced Jamba-v0.1-52B and reduced xLSTM-125M,
the same parameters (the reference's, key 0), the prompts' and the fed
decode tokens the same numpy draw (teacher forcing).

Each case is a one-rank prefill's cache cut by ``shard_decode_cache``
(a slice of every attention layer's slots on each data rank, MLA's ckv
and krope too; every recurrent state whole on every data rank, split
by channels over a model group), then 4 decode steps whose slots lie on
two data ranks, on (4, 1) at batches 1 and 2 and on (2, 2) at batch 1:

- every step's logits against the reference's ``build_decode_step`` on
  the same mesh with the same cache put there by ``decode_cache_specs``
  and against its one-device ``decode_step``; xLSTM on (2, 2) against
  the one-device decode only, since the reference cannot place that
  cache (its ``decode_cache_specs`` puts ``model`` on the batch axis of
  a 3-D recurrent leaf, ROADMAP "Reference caveats");
- every rank's logits bitwise equal, and after the last step every
  recurrent leaf bitwise equal across the data ranks that hold the same
  share of it;
- the cache's layout: the attention leaves' slots split over the data
  ranks, the recurrent leaves the one-rank cache's shape (cut by
  channels over a model group).

Tolerance: tests/test_torch_serve.py's rtol = atol = 1e-5. Ranks meet
through a ``file://`` rendezvous under tmp_path."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_threads import one_thread  # noqa: E402,F401
import test_torch_tensor_parallel as tpt  # noqa: E402
import test_torch_world_serve as ws  # noqa: E402

RTOL = ATOL = 1e-5
PROMPT, SEQ, STEPS = ws.PROMPT, ws.SEQ, ws.STEPS
MODELS = {"mla_expanded": dict(arch="deepseek-v2-lite-16b"),
          "mla_absorbed": dict(arch="deepseek-v2-lite-16b", absorb=True),
          "jamba": dict(arch="jamba-v0.1-52b"),
          "xlstm": dict(arch="xlstm-125m")}
LAYOUTS = [((4, 1), 1), ((4, 1), 2), ((2, 2), 1)]
CASES = {f"{model}_{mesh[0]}x{mesh[1]}_b{batch}": dict(
    model=model, mesh=list(mesh), batch=batch, prompt=PROMPT, seq=SEQ)
    for model in MODELS for mesh, batch in LAYOUTS}
# the reference cannot place this case's cache (module docstring)
ONE_DEVICE_ONLY = {"xlstm_2x2_b1"}


def _tokens():
    return np.random.default_rng(31).integers(
        0, 512, (2, PROMPT + STEPS)).astype(np.int32)


def run_reference(tmp, mode: str, **data) -> dict:
    """tests/jax_mesh_worker.py's ``mode`` over 4 host devices on the
    inputs ``data``: its outputs."""
    np.savez(tmp / "inputs.npz", mode=mode, **data)
    p = subprocess.run(
        [sys.executable, os.path.join(tpt.HERE, "jax_mesh_worker.py"), "4",
         str(tmp / "inputs.npz"), str(tmp / "out.npz")],
        env=tpt._env(), capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stdout + p.stderr
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("reference"), "cp",
                         models=json.dumps(MODELS), cases=json.dumps(CASES),
                         tokens=_tokens())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    init = {key: val for key, val in reference.items()
            if key.split("/")[0].endswith("_init")}
    return tpt._spawn_ranks(tmp_path_factory.mktemp("cp"), "cp_serve", 4,
                            models=json.dumps(MODELS),
                            cases=json.dumps(CASES),
                            tokens=_tokens().astype(np.int64), **init)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_context_parallel_decode_matches_reference(ranks, reference, name):
    """Every rank's logits are the same bits and those of the reference's
    context-parallel decode of the same cache on the same mesh (where it
    can place it) and of its one-device decode."""
    for t in range(STEPS):
        got = ranks[0][f"{name}_decode_{t}"]
        for r, out in enumerate(ranks):
            assert not bool(out["jax_imported"])
            assert np.array_equal(out[f"{name}_decode_{t}"], got), (t, r)
        _close(got, reference[f"{name}_one_decode_{t}"], f"step {t} one")
        if name in ONE_DEVICE_ONLY:
            assert f"{name}_mesh_decode_{t}" not in reference
            continue
        _close(got, reference[f"{name}_mesh_decode_{t}"], f"step {t} mesh")
    if name in ONE_DEVICE_ONLY:
        assert f"{name}_mesh_error" in reference


@pytest.mark.parametrize("name", sorted(CASES))
def test_recurrent_state_is_whole_on_every_data_rank(ranks, name):
    """The attention leaves hold a slice of the slots on each data rank;
    every other leaf keeps the one-rank cache's rows (cut by channels
    over a model group), and after the last step the recurrent leaves
    hold the same bits on every data rank of a model index."""
    case = CASES[name]
    data, model = case["mesh"]
    for r, out in enumerate(ranks):
        same = ranks[r % model]
        assert np.array_equal(out[f"{name}_state"], same[f"{name}_state"]), r
        shapes = {key[len(name) + 7:]: val for key, val in out.items()
                  if key.startswith(f"{name}_shape_")}
        assert shapes, name
        for path, shape in shapes.items():
            leaf = path.split("_")[-1]
            if leaf in ("k", "v", "ckv", "krope"):
                lead = int(path.startswith("blocks"))
                assert shape[lead] == case["batch"], (path, shape)
                assert shape[lead + 1] == SEQ // data, (path, shape)
            elif path != "pos":
                lead = int(path.startswith("blocks"))
                assert shape[lead] == case["batch"], (path, shape)
    if MODELS[case["model"]]["arch"] != "deepseek-v2-lite-16b":
        assert ranks[0][f"{name}_state"].size > 0
