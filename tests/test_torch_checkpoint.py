"""The port's checkpoints (``repro_torch.checkpoint.io`` and the train
step's ``save_train_state`` / ``restore_train_state``) against the
reference's ``repro.checkpoint.io``, on the CPU: a checkpoint written by
either package restores in the other bit for bit (fp32, bf16 and uint32
leaves), the legacy ``(a_prev, s_prev)`` EF pair migrates as the
reference migrates it, an EF leaf fits a changed worker count (4 -> 2 and
2 -> 3) as the reference fits it, and a TrainState crosses in the
reference's global (DP, TP, ...) layout, from one rank and from a gloo
group of two."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.core.flatten import tree_items  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _bits(a) -> np.ndarray:
    """Bit pattern of a tensor or array (floats as unsigned integers)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16 or a.dtype.kind == "V":
        return a.view(np.uint16)
    return a.view({1: np.uint8, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _assert_same(port_tree, ref_tree):
    got, want = tree_items(port_tree), tree_items(ref_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == np.shape(w), path
        assert np.array_equal(_bits(g), _bits(w)), path


def _trees(seed: int, j: int = 300):
    """(params, opt, ef) as numpy in the reference's layout: a bf16 leaf,
    (1, 1, ...) state vectors, a uint32 idx_prev, 0-d int32 steps."""
    rng = np.random.default_rng(seed)
    params = {"blocks": {"l0": {"wq": rng.normal(size=(2, 4, 6))
                                .astype(np.float32)}},
              "embed": {"tok": rng.normal(size=(9, 4))
                        .astype(ml_dtypes.bfloat16)},
              "final_norm": {"scale": rng.normal(size=4).astype(np.float32)}}
    vec = lambda n: rng.normal(size=(1, 1, n)).astype(np.float32)  # noqa
    opt = {"master": vec(j), "m": vec(j), "v": vec(j),
           "step": np.int32(3)}
    ef = {"err_prev": vec(j), "a_prev_sel": vec(8), "g_prev_sel": vec(8),
          "idx_prev": rng.integers(0, 2 ** 32, (1, 1, 8), dtype=np.uint64)
          .astype(np.uint32), "step": np.int32(3)}
    return params, opt, ef


def _port_template(tree):
    """Zero tensors of the reference tree's shapes and the port's dtypes
    (bf16 as bf16, uint32 as its int32 view)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.zeros(a.shape, dtype=torch.bfloat16)
        dt = np.int32 if a.dtype == np.uint32 else a.dtype
        return torch.zeros(a.shape, dtype=torch.from_numpy(
            np.zeros(0, dt)).dtype)
    return jax.tree_util.tree_map(leaf, tree)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params, opt, ef = _trees(0)
    jio.save_checkpoint(str(tmp_path), 7, params, opt, ef, param_version=5)
    assert tio.latest_step(str(tmp_path)) == 7
    assert tio.read_manifest(str(tmp_path), 7) == {"step": 7,
                                                   "param_version": 5}
    got = tio.restore_checkpoint(str(tmp_path), 7, *(
        _port_template(t) for t in (params, opt, ef)))
    for g, w in zip(got, (params, opt, ef)):
        _assert_same(g, w)
    assert got[0]["embed"]["tok"].dtype == torch.bfloat16
    assert got[2]["idx_prev"].dtype == torch.int32


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params, opt, ef = _trees(1)
    tparams, topt, tef = (jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a).view(np.int16)).view(
            torch.bfloat16) if np.asarray(a).dtype == ml_dtypes.bfloat16
        else torch.from_numpy(np.asarray(a).view(np.int32)
                              if np.asarray(a).dtype == np.uint32
                              else np.asarray(a)), t)
        for t in (params, opt, ef))
    tio.save_checkpoint(str(tmp_path), 2, tparams, topt, tef,
                        param_version=9)
    assert jio.read_manifest(str(tmp_path), 2)["param_version"] == 9
    zeros = [jax.tree_util.tree_map(lambda a: jnp.zeros(
        np.shape(a), jnp.asarray(a).dtype), t) for t in (params, opt, ef)]
    got = jio.restore_checkpoint(str(tmp_path), 2, *zeros)
    for g, w in zip(got, (params, opt, ef)):
        for (path, x), (_, y) in zip(tree_items(g), tree_items(w)):
            assert np.asarray(x).dtype == np.asarray(y).dtype, path
            assert np.array_equal(_bits(x), _bits(y)), path
    with np.load(os.path.join(tmp_path, "step_00000002.params.npz")) as d:
        assert d["['embed']['tok']"].dtype == np.dtype("V2")
        assert set(d.files) == {"['blocks']['l0']['wq']",
                                "['embed']['tok']",
                                "['final_norm']['scale']"}


def test_legacy_ef_pair_migrates_as_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    j = 513
    legacy = {"a_prev": rng.normal(size=(1, 1, j)).astype(np.float32),
              "s_prev": (rng.uniform(size=(1, 1, j)) < 0.05)
              .astype(np.uint8), "step": np.int32(9)}
    t = {"x": np.ones(2, np.float32)}
    jio.save_checkpoint(str(tmp_path), 3, t, t, legacy)
    tmpl = {"err_prev": np.zeros((1, 1, j), np.float32), "step": np.int32(0)}
    _, _, want = jio.restore_checkpoint(str(tmp_path), 3, t, t, tmpl)
    tt = {"x": torch.zeros(2)}
    _, _, got = tio.restore_checkpoint(
        str(tmp_path), 3, tt, tt, {"err_prev": torch.zeros((1, 1, j)),
                                   "step": torch.zeros((), dtype=torch.int32)})
    _assert_same(got, want)
    with pytest.raises(KeyError, match="not_there"):
        tio.restore_checkpoint(str(tmp_path), 3, tt, tt,
                               {"not_there": torch.zeros(3)})


@pytest.mark.parametrize("saved,wanted", [(4, 2), (2, 3)])
def test_ef_fits_a_changed_worker_count_as_the_reference(tmp_path, saved,
                                                         wanted):
    rng = np.random.default_rng(saved)
    j = 37
    ef = {"err_prev": rng.normal(size=(saved, 1, j)).astype(np.float32),
          "step": np.int32(4)}
    t = {"x": np.ones(2, np.float32)}
    jio.save_checkpoint(str(tmp_path), 1, t, t, ef)
    _, _, want = jio.restore_checkpoint(
        str(tmp_path), 1, t, t, {"err_prev": np.zeros((wanted, 1, j),
                                                      np.float32),
                                 "step": np.int32(0)})
    tt = {"x": torch.zeros(2)}
    meta = torch.device("meta")
    _, _, got = tio.restore_checkpoint(
        str(tmp_path), 1, tt, tt,
        {"err_prev": torch.empty((wanted, 1, j), device=meta),
         "step": torch.zeros((), dtype=torch.int32)}, device="cpu")
    _assert_same(got, want)
    keep = min(saved, wanted)
    assert np.array_equal(got["err_prev"][:keep].numpy(),
                          ef["err_prev"][:keep])
    assert not got["err_prev"][keep:].any()
    with pytest.raises(ValueError, match="trailing"):
        tio.restore_checkpoint(str(tmp_path), 1, tt, tt, {
            "err_prev": torch.empty((wanted, 1, j + 1), device=meta),
            "step": torch.zeros((), dtype=torch.int32)}, device="cpu")


def _run():
    from repro_torch.configs import base as cfgs
    return cfgs.RunConfig(
        model=cfgs.reduced_config(cfgs.get_config("stablelm-3b")),
        shape=cfgs.SHAPES["train_4k"],
        sparsifier=cfgs.SparsifierConfig(kind="regtopk", sparsity=0.01,
                                         comm_mode="sparse",
                                         pipeline="fused"),
        optimizer=cfgs.OptimizerConfig(kind="adam", lr=1e-3), steps=2)


def test_train_state_crosses_packages_at_one_rank(tmp_path):
    """A trained TrainState saved by the port is the reference's global
    layout (restored by ``repro.checkpoint``); the reference's save of
    that layout restores into the port's TrainState; and the port's own
    round trip is exact, the training going on from it as from the
    original."""
    from repro_torch.data import lm_batch
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        restore_train_state,
                                        save_train_state)
    run = _run()
    step = build_train_step(run, "cpu")
    batch = lm_batch(run.model, 2, 16, 0, 0, "cpu")
    state, _ = step(init_train_state(run, "cpu"), batch)
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    save_train_state(a, 1, state, param_version=1)
    glob = {"opt": {k: v.detach().numpy()[None, None] if v.ndim else
                    v.numpy() for k, v in state.opt.items()},
            "ef": {k: (v.numpy().view(np.uint32) if k == "idx_prev"
                       else v.numpy())[None, None] if v.ndim else v.numpy()
                   for k, v in state.ef.items()}}
    params_np = jax.tree_util.tree_map(lambda t: t.detach().numpy(),
                                       state.params)
    zeros = lambda t: jax.tree_util.tree_map(np.zeros_like, t)  # noqa
    ref = jio.restore_checkpoint(a, 1, zeros(params_np), zeros(glob["opt"]),
                                 zeros(glob["ef"]))
    for g, w in zip(ref, (params_np, glob["opt"], glob["ef"])):
        for (path, x), (_, y) in zip(tree_items(g), tree_items(w)):
            assert np.asarray(x).dtype == np.asarray(y).dtype, path
            assert np.array_equal(_bits(x), _bits(y)), path
    jio.save_checkpoint(b, 1, params_np, glob["opt"], glob["ef"],
                        param_version=1)
    for ckpt in (a, b):
        back = restore_train_state(ckpt, 1, run, "cpu")
        for x, y in ((back.params, state.params), (back.opt, state.opt),
                     (back.ef, state.ef)):
            for (path, g), (_, w) in zip(tree_items(x), tree_items(y)):
                assert g.dtype == w.dtype and torch.equal(g, w.detach()), path
    _, m1 = step(back, batch)
    _, m2 = step(restore_train_state(a, 1, run, "cpu"), batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_train_state_from_a_gloo_group(tmp_path):
    """Two gloo ranks save one checkpoint (rank 0 writes the gathered
    (2, 1, ...) rows) and each restores its own row; at one rank the
    optimizer's two ZeRO-1 slices raise (the reference does not reshard
    them either)."""
    from repro_torch.train.step import restore_train_state
    world = 2
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (world, 2, 16)).astype(np.int64)
    targets = np.concatenate(
        [tokens[:, :, 1:], -np.ones((world, 2, 1), np.int64)], 2)
    ckpt = str(tmp_path / "ckpt")
    inp = tmp_path / "inputs.npz"
    np.savez(inp, sparsity=0.01, mu=0.5, kind="regtopk", steps=1,
             tokens=tokens, targets=targets, ckpt=ckpt)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"),
         "checkpoint", str(r), str(world), str(tmp_path / "rendezvous"),
         str(inp), str(tmp_path / f"rank{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for res in ranks:
        assert bool(res["restored_equal"]) and not bool(res["jax_imported"])
    with np.load(os.path.join(ckpt, "step_00000001.ef.npz")) as d:
        err = d["['err_prev']"]
        assert err.shape[:2] == (2, 1)
        for r, res in enumerate(ranks):
            assert np.array_equal(err[r, 0], res["ef_err_prev"])
        assert d["['idx_prev']"].dtype == np.uint32
    with pytest.raises(ValueError, match="world of 1"):
        restore_train_state(ckpt, 1, _run(), "cpu")
