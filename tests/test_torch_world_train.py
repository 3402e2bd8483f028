"""The port's data-parallel train step over gloo process groups against
the reference's ``build_train_step`` on meshes of host CPU devices
(tests/jax_mesh_worker.py's mode "train", one subprocess for the
module): reduced StableLM-3B, REGTOP-k fused with sparse comm, Adam,
one fixed global batch of (8, 32) whose rows split over the ranks as the
reference's ``P(dpaxes, None)`` splits them, 3 steps, the same initial
parameters.

- a world of 2 against a (2, 1) mesh: the logged metrics are the
  group's means (the reference ``pmean``s every metric);
- a world of 4 against a (4, 1) mesh and a (2, 2, 1) pods mesh: loss,
  ``gnorm_local`` and ``agg_nonzero`` to rtol 1e-5, each rank's sorted
  ``idx_prev`` bitwise, the parameters to atol 1e-5
  (tests/test_torch_train.py's tolerances), and the ranks bitwise equal
  to each other;
- DGC fused under ``bursty:period=3,outage=1,workers=0`` at a world of
  4: n_active per step equal to the reference's;
- the launcher's ``main()`` with ``--data 2 --device cpu`` at gloo world
  2: each rank's rows of the global batch, and its losses equal to
  ``train()`` with the group; ``--model 2`` of an xLSTM, Jamba, MLA,
  encoder-decoder or vision model, and ``--data 2`` without a
  group raise.

Ranks meet through a ``file://`` rendezvous under tmp_path."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS, BATCH, SEQ = 3, 8, 32
LOSS_RTOL = 1e-5            # tests/test_torch_train.py's
PARAM_ATOL = 1e-5
MAIN = dict(kind="regtopk", sparsity=0.01, mu=0.5, pipeline="fused",
            comm_mode="sparse")
DGC = dict(kind="dgc", sparsity=0.01, pipeline="fused", comm_mode="sparse",
           err_decay=0.9)
SCHEDULE = "bursty:period=3,outage=1,workers=0"
# the reference's cases: mesh shape, sparsifier, fault schedule
REFERENCE = {"w2": dict(mesh=[2, 1], sparsifier=MAIN),
             "w4": dict(mesh=[4, 1], sparsifier=MAIN),
             "pods": dict(mesh=[2, 2, 1], sparsifier=MAIN),
             "dgc": dict(mesh=[4, 1], sparsifier=DGC, schedule=SCHEDULE)}
METRICS = ("loss", "gnorm_local", "agg_nonzero")


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
                OMP_NUM_THREADS="1")


def _batch():
    rng = np.random.default_rng(24)
    tokens = rng.integers(0, 512, (BATCH, SEQ)).astype(np.int64)
    targets = np.concatenate([tokens[:, 1:], -np.ones((BATCH, 1),
                                                      np.int64)], 1)
    return tokens, targets


def _spawn_ranks(tmp, mode, world, **data):
    inp = tmp / f"{mode}{world}.npz"
    np.savez(inp, **data)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"), mode,
         str(r), str(world), str(tmp / f"rendezvous_{mode}{world}"),
         str(inp), str(tmp / f"{mode}{world}_rank{r}.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp / f"{mode}{world}_rank{r}.npz"))
            for r in range(world)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's four cases, run in one process of 4 devices."""
    tmp = tmp_path_factory.mktemp("reference")
    tokens, targets = _batch()
    np.savez(tmp / "inputs.npz", mode="train", steps=STEPS, tokens=tokens,
             targets=targets, cases=json.dumps(REFERENCE))
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "jax_mesh_worker.py"), "4",
         str(tmp / "inputs.npz"), str(tmp / "out.npz")],
        env=_env(), capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    return dict(np.load(tmp / "out.npz"))


def _world(tmp, reference, world: int, cases: dict):
    tokens, targets = _batch()
    return _spawn_ranks(tmp, "world_train", world, steps=STEPS,
                        tokens=tokens, targets=targets,
                        init_params=reference["init_params"],
                        cases=json.dumps(cases))


@pytest.fixture(scope="module")
def world4(tmp_path_factory, reference):
    return _world(tmp_path_factory.mktemp("world4"), reference, 4,
                  {"main": dict(sparsifier=MAIN),
                   "dgc": dict(sparsifier=DGC, schedule=SCHEDULE)})


def _metrics_match(ranks, reference, name: str, ref_name: str):
    for t in range(STEPS):
        for key in METRICS:
            want = float(reference[f"{ref_name}_{key}_{t}"])
            for r, res in enumerate(ranks):
                got = res[f"{name}_{key}_{t}"]
                assert got == ranks[0][f"{name}_{key}_{t}"], (key, t, r)
                np.testing.assert_allclose(float(got), want,
                                           rtol=LOSS_RTOL,
                                           err_msg=f"{key} step {t}")


def test_world2_metrics_are_the_group_means(tmp_path, reference):
    """Every logged metric is the reference's ``pmean`` over the data
    axes: at a world of 2 each rank's ``gnorm_local`` and
    ``agg_nonzero`` are its own, and the step averages them over the
    group, as it does the loss."""
    ranks = _world(tmp_path, reference, 2, {"main": dict(sparsifier=MAIN)})
    _metrics_match(ranks, reference, "main", "w2")
    for res in ranks:
        assert not bool(res["jax_imported"])


@pytest.mark.parametrize("mesh", ["w4", "pods"])
def test_world4_train_matches_the_reference_mesh(world4, reference, mesh):
    """Gloo world 4 against the reference on a (4, 1) mesh and on a
    (2, 2, 1) pods mesh (rank r is pod r // 2, data r % 2)."""
    _metrics_match(world4, reference, "main", mesh)
    want = reference[f"{mesh}_params"]
    for r, res in enumerate(world4):
        assert not bool(res["jax_imported"])
        assert np.array_equal(res["main_params"].view(np.int32),
                              world4[0]["main_params"].view(np.int32)), r
        ref_idx = np.sort(reference[f"{mesh}_idx_prev"][r].reshape(-1))
        assert np.array_equal(res["main_idx_prev"], ref_idx), r
    np.testing.assert_allclose(world4[0]["main_params"], want, rtol=0,
                               atol=PARAM_ATOL)


def test_world4_dgc_elastic_matches_the_reference(world4, reference):
    """DGC fused under the bursty schedule (rank 0 out on steps 0 and 3):
    n_active each step, the metrics and the parameters."""
    for t in range(STEPS):
        want = float(reference[f"dgc_n_active_{t}"])
        assert want == (3.0 if t % 3 == 0 else 4.0)
        for res in world4:
            assert float(res[f"dgc_n_active_{t}"]) == want, t
    _metrics_match(world4, reference, "dgc", "dgc")
    np.testing.assert_allclose(world4[0]["dgc_params"],
                               reference["dgc_params"], rtol=0,
                               atol=PARAM_ATOL)


LAUNCH = ["--arch", "stablelm-3b", "--smoke", "--steps", "2", "--batch",
          "4", "--seq", "16", "--comm", "sparse", "--pipeline", "fused",
          "--fixed-batch", "--log-every", "1", "--device", "cpu"]


def test_launcher_main_over_gloo_world2(tmp_path):
    """``main()`` with ``--data 2`` inside a gloo group of 2: rank r
    trains on rows [2r, 2r + 2) of the launcher's global batch of 4, and
    its losses equal ``train()``'s with the group on the same config."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.data import lm_batch
    ranks = _spawn_ranks(tmp_path, "launch", 2,
                         flags=np.asarray(LAUNCH + ["--data", "2"]))
    glob = lm_batch(reduced_config(get_config("stablelm-3b")), 4, 16, 0, 0,
                    "cpu")["tokens"].numpy()
    for r, res in enumerate(ranks):
        assert not bool(res["jax_imported"])
        assert res["tokens"].shape == (2, 2, 16)
        for step_rows in res["tokens"]:
            assert np.array_equal(step_rows, glob[2 * r:2 * r + 2])
        assert np.array_equal(res["losses"], res["train_losses"])
        assert np.array_equal(res["losses"], ranks[0]["losses"])
        assert np.all(np.isfinite(res["losses"]))


def test_launcher_model_parallel_raises_a13(monkeypatch):
    """``--model 2`` of Whisper-small (an encoder-decoder) trains since
    A13d's last part (tests/test_torch_tensor_parallel_encdec.py), and
    with the bucket auto-tune (``--num-buckets 0``) too: the launcher's
    checks pass and, without torchrun's environment, it finds no group
    to join. The count it would log at (data 2, model 2) comes from the
    reference's J_local (its rank's tree at tp 2) and dp, and is the
    reference's count there: one bucket (the payload is far below either
    package's launch floor)."""
    import dataclasses

    import jax
    from repro.configs import base as jbase
    from repro.core import sparsify as jsp
    from repro.models import init_params as jax_init_params
    from repro.models.parallel import Parallel as JaxParallel
    from repro_torch.launch import train as launcher
    from repro_torch.models.parallel import Parallel
    from repro_torch.train import step as tstep
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launcher.main(LAUNCH + ["--arch", "whisper-small", "--model", "2",
                                "--num-buckets", "0"])

    class Groups(Parallel):
        # rank 0's view of a (2, 2) grid: model rank 0 of 2
        tp, tp_on, model_rank = 2, True, 0
    monkeypatch.setattr(tstep, "train_parallel", lambda *a, **kw: Groups())
    monkeypatch.setattr(tstep, "world", lambda group=None: (2, 0))
    run = launcher.run_config(launcher.parse_args(
        LAUNCH + ["--arch", "whisper-small", "--num-buckets", "0"]))
    nb, j_local, dp = tstep.auto_num_buckets_for_run(run)
    assert dp == 2
    jcfg = jbase.SparsifierConfig(**dataclasses.asdict(run.sparsifier))
    assert nb == jsp.resolve_num_buckets(jcfg, j_local, dp)
    # J_local: the reference's per-rank tree of the same model at tp 2
    want = sum(int(leaf.size) for leaf in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jax_init_params(
            jbase.reduced_config(jbase.get_config("whisper-small")),
            JaxParallel(model_axis="model", tp=2), jax.random.PRNGKey(0)))))
    assert j_local == want


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v2-lite-16b",
                                  "whisper-small", "phi-3-vision-4.2b"])
def test_launcher_model_parallel_gates(arch, monkeypatch):
    """Every family passes the launcher's checks under ``--model 2``, the
    encoder-decoder and the vision stub since A13d's last part, with a
    checkpoint directory and a delta spool too: without torchrun's
    environment each then finds no group to join."""
    from repro_torch.launch import train as launcher
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launcher.main(LAUNCH + ["--arch", arch, "--model", "2",
                                "--checkpoint-dir", "ckpt",
                                "--publish-deltas", "spool"])


@pytest.mark.parametrize("flags", [["--data", "2"], ["--pods", "2"]])
def test_launcher_data_parallel_without_a_group_raises(flags, monkeypatch):
    """Without torchrun's environment there is no group to join: the
    launcher raises and never trains one rank in its place."""
    from repro_torch.launch import train as launcher
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launcher.main(LAUNCH + flags)
