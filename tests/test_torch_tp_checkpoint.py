"""Checkpoints and the delta broadcast under tensor parallelism, against
the reference's on a ("data", "model") mesh of host CPU devices
(tests/jax_mesh_worker.py's mode "tp" with a ``ckpt`` case) and the
port's ranks over gloo (tests/torch_gloo_worker.py's mode "tp_train",
``tp_checkpoint``): reduced StableLM-3B on (1, 4) and (2, 2), and under
ring attention (``attn_dist="ring"``: every rank all the heads of its
own attention weights) on (1, 4), REGTOP-k fused with sparse comm, Adam,
from the reference's initial parameters.

- The reference's ``save_checkpoint`` of its state after one step,
  restored by the port's ``restore_train_state`` on every rank and saved
  again by ``save_train_state``, gives the reference's files back leaf
  for leaf, bit for bit: the parameters joined over the model group
  (``convert.join_params``), the optimizer and sparsifier states as
  ``(DP, TP, ...)``.
- The port's own checkpoint after one step restores equal, bit for bit,
  on every rank, and the live and the restored state stay equal over
  two more steps: beside the reference's three files it keeps every
  model rank's copy of the replicated leaves (``.replicated.npz``,
  ``(TP, ...)``), which drift apart under the sparsified sync while the
  global tree holds model rank 0's (ROADMAP Queue C).
- A ``DeltaPublisher`` on the parameters joined over the model group
  (``train.step.joined_params``) of the reference's state before and
  after every step publishes the reference publisher's payloads (values,
  indices, checksum) bit for bit.

Ranks meet through a ``file://`` rendezvous under tmp_path."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_threads import one_thread  # noqa: E402,F401
import test_torch_tensor_parallel as tpt  # noqa: E402
import test_torch_tensor_parallel_ssm as tps  # noqa: E402

DELTA_K = 64
NAMES = {"ckpt_1x4": [1, 4], "ckpt_2x2": [2, 2], "ckpt_ring_1x4": [1, 4]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the port's ranks' outputs, the cases)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    cases = {name: dict(arch="stablelm-3b", mesh=mesh,
                        sparsifier=tpt.MAIN, ckpt=str(tmp / name),
                        delta_k=DELTA_K,
                        **({"attn_dist": "ring"} if "ring" in name else {}))
             for name, mesh in NAMES.items()}
    inp = tpt._inputs()
    batch = dict(tokens=inp["tokens"], targets=inp["targets"])
    ref = tps._run_reference(tmp, {"train": dict(
        steps=tpt.STEPS, train_cases=json.dumps(cases), **batch)})
    init = {key: val for key, val in ref.items()
            if any(key.startswith(f"{name}_init/")
                   or key.startswith(f"{name}_step") for name in cases)}
    ranks = tpt._spawn_ranks(tmp, "tp_train", 4, steps=tpt.STEPS,
                             cases=json.dumps(cases), **batch, **init)
    return ref, ranks, cases


def _npz(path: str) -> dict:
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


@pytest.mark.parametrize("name", list(NAMES))
def test_checkpoint_files_equal_the_reference(runs, name):
    """The port's save of the restored reference state is the reference's
    checkpoint, file for file, leaf for leaf, bit for bit; the port's own
    checkpoint has the reference's keys, shapes and dtypes."""
    _, _, cases = runs
    ckpt = cases[name]["ckpt"]
    for suffix in (".params.npz", ".opt.npz", ".ef.npz"):
        want = _npz(f"{ckpt}/step_00000001{suffix}")
        for again in (f"{ckpt}_again", f"{ckpt}_port"):
            got = _npz(f"{again}/step_00000001{suffix}")
            assert sorted(got) == sorted(want), (again, suffix)
            for key, val in want.items():
                assert got[key].shape == val.shape, (again, key)
                assert got[key].dtype == val.dtype, (again, key)
                if again.endswith("_again"):
                    assert np.array_equal(got[key], val), (suffix, key)
    data, tp = NAMES[name]
    opt = _npz(f"{ckpt}/step_00000001.opt.npz")
    assert opt["['master']"].shape[:2] == (data, tp)
    params = _npz(f"{ckpt}/step_00000001.params.npz")
    copies = _npz(f"{ckpt}_port/step_00000001.replicated.npz")
    assert copies and "['final_norm']['scale']" in copies
    for key, val in copies.items():
        assert val.shape == (tp,) + params[key].shape, key
    with open(f"{ckpt}_again/step_00000001.json") as f:
        assert json.load(f) == {"step": 1, "param_version": 1}


@pytest.mark.parametrize("name", list(NAMES))
def test_restore_continues_bitwise(runs, name):
    _, ranks, _ = runs
    for res in ranks:
        assert not bool(res["jax_imported"])
        assert bool(res[f"{name}_restored_equal"])
        assert bool(res[f"{name}_continued_equal"])


@pytest.mark.parametrize("name", list(NAMES))
def test_published_payloads_equal_the_reference(runs, name):
    """Rank 0's publisher on the joined tree: every version's values,
    indices and checksum equal the reference publisher's on its global
    tree."""
    ref, ranks, _ = runs
    for v in range(1, tpt.STEPS + 1):
        for key in ("values", "indices", "checksum"):
            got = ranks[0][f"{name}_delta{v}_{key}"]
            want = ref[f"{name}_delta{v}_{key}"]
            assert got.dtype == want.dtype or key == "checksum", key
            assert np.array_equal(got, want), (v, key)
