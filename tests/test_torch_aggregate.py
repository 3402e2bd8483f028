"""The port's GradientSync over real gloo process groups against the
reference's in-process ``GradientSync.round`` on the same per-worker
gradients, bitwise.

With n a power of two, scaling by 1/n is exact, so the reference's
sum_n (1/n) * ghat_n equals the port's (sum_n ghat_n) / n bit for bit
when both add in rank order; g_agg and every rank's state must match,
and g_agg must be identical on every rank. Ranks are separate processes
that import no jax, meeting through a ``file://`` rendezvous under
tmp_path (no TCP port shared between test workers)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SparsifierConfig as JaxSparsifierConfig  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.core.aggregate import GradientSync as JaxGradientSync  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
T, J, SPARSITY, MU = 3, 3 * 4096 + 517, 0.01, 0.5


def _run_world(tmp_path, mode, world, **data):
    inp = tmp_path / "inputs.npz"
    np.savez(inp, sparsity=SPARSITY, mu=MU, **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"), mode,
         str(r), str(world), str(tmp_path / "rendezvous"), str(inp),
         str(tmp_path / f"rank{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world,kind", [(2, "topk"), (2, "regtopk"),
                                        (4, "regtopk")])
def test_gloo_sync_matches_reference_round(tmp_path, world, kind):
    rng = np.random.default_rng(world)
    grads = rng.standard_normal((T, world, J)).astype(np.float32)
    ranks = _run_world(tmp_path, "sync", world, grads=grads, kind=kind)
    cfg = JaxSparsifierConfig(kind=kind, sparsity=SPARSITY, mu=MU,
                              pipeline="fused", comm_mode="sparse")
    rnd = jax.jit(lambda sts, gs: JaxGradientSync(cfg, None).round(sts, gs))
    states = [jsp.init_state(cfg, J) for _ in range(world)]
    for t in range(T):
        g_agg, states = rnd(states, [jnp.asarray(g) for g in grads[t]])
        want = np.asarray(g_agg).view(np.int32)
        for r, res in enumerate(ranks):
            assert np.array_equal(res[f"g_agg_{t}"].view(np.int32), want), \
                (t, r)
    for r, res in enumerate(ranks):
        assert not bool(res["jax_imported"])
        for key, val in jax.device_get(states[r]).items():
            got = res[f"state_{key}"]
            val = np.asarray(val)
            if val.dtype == np.uint32:
                val = val.view(np.int32)
            assert np.array_equal(got.view(np.int32) if got.dtype ==
                                  np.float32 else got,
                                  val.view(np.int32) if val.dtype ==
                                  np.float32 else val), (r, key)


def test_gloo_train_step_matches_in_process_emulation(tmp_path):
    """Two gloo ranks, each with its own batch, through the port's
    data-parallel train step (ZeRO-1 slices + all-gather of the master):
    every rank ends with the same parameters, bitwise equal to an
    in-process emulation that syncs with GradientSync.round and updates
    the whole vector at once (Adam is elementwise, so the slicing must
    not change a bit)."""
    from torch_gloo_worker import train_run
    from repro_torch.core.aggregate import GradientSync
    from repro_torch.core import sparsify
    from repro_torch.core.flatten import TreeFlattener, tree_leaves
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import apply_updates, init_opt_state
    world, steps = 2, 2
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (world, 2, 16)).astype(np.int64)
    targets = np.concatenate(
        [tokens[:, :, 1:], -np.ones((world, 2, 1), np.int64)], 2)
    data = dict(tokens=tokens, targets=targets, kind="regtopk", steps=steps)
    ranks = _run_world(tmp_path, "train", world, **data)
    run = train_run(dict(data, sparsity=SPARSITY, mu=MU))
    params = init_params(run.model, torch.Generator().manual_seed(run.seed),
                         "cpu")
    flat = TreeFlattener(params)
    master = flat.flatten(params)
    opt = init_opt_state(run.optimizer, master)
    sync = GradientSync(run.sparsifier)
    states = [sparsify.init_state(run.sparsifier, flat.total, "cpu")
              for _ in range(world)]
    for _ in range(steps):
        tree = flat.unflatten(master.clone())
        leaves = [t.requires_grad_(True) for t in tree_leaves(tree)]
        grads = []
        for r in range(world):
            batch = {"tokens": torch.from_numpy(tokens[r]),
                     "targets": torch.from_numpy(targets[r])}
            loss = loss_fn(tree, batch, run.model)
            grads.append(flat.flatten(list(torch.autograd.grad(loss,
                                                               leaves))))
        g_agg, states = sync.round(states, grads)
        master, opt = apply_updates(run.optimizer, opt, g_agg)
    want = master.numpy().view(np.int32)
    for res in ranks:
        assert not bool(res["jax_imported"])
        assert np.all(np.isfinite(res["losses"]))
        assert np.array_equal(res["params"].view(np.int32), want)


@pytest.mark.parametrize("world,data", [(2, "gauss"), (4, "dyadic")])
def test_gloo_sketch_sync_matches_reference_round(tmp_path, world, data):
    """kind="sketchtopk" over gloo: the sketch all-reduce, the shared-mask
    decode and the values-only all-gather against the reference's
    in-process round. World 4 takes dyadic gradients (k * 2^-8, |k| <=
    2^10), whose sums are exact in any order, because gloo's all-reduce
    adds four sketches in its own order. g_agg must be bitwise identical
    on every rank, and equal the reference's up to the sign of zero: the
    reference's round sums the dense vectors mask * a, whose unselected
    entries are -0.0 where every worker's a is negative, while the
    per-step path scatters into zeros (+0.0)."""
    rng = np.random.default_rng(10 + world)
    if data == "gauss":
        grads = rng.standard_normal((T, world, J)).astype(np.float32)
    else:
        grads = (rng.integers(-1024, 1025, (T, world, J))
                 * 2.0 ** -8).astype(np.float32)
    ranks = _run_world(tmp_path, "sync", world, grads=grads,
                       kind="sketchtopk")
    cfg = JaxSparsifierConfig(kind="sketchtopk", sparsity=SPARSITY,
                              pipeline="fused", comm_mode="sparse")
    rnd = jax.jit(lambda sts, gs: JaxGradientSync(cfg, None).round(sts, gs))
    states = [jsp.init_state(cfg, J) for _ in range(world)]
    for t in range(T):
        g_agg, states = rnd(states, [jnp.asarray(g) for g in grads[t]])
        want = (np.asarray(g_agg) + np.float32(0.0)).view(np.int32)
        first = ranks[0][f"g_agg_{t}"].view(np.int32)
        for r, res in enumerate(ranks):
            got = res[f"g_agg_{t}"]
            assert np.array_equal(got.view(np.int32), first), (t, r)
            assert np.array_equal((got + np.float32(0.0)).view(np.int32),
                                  want), (t, r)
    for r, res in enumerate(ranks):
        assert not bool(res["jax_imported"])
        for key, val in jax.device_get(states[r]).items():
            assert np.array_equal(res[f"state_{key}"].view(np.int32),
                                  np.asarray(val).view(np.int32)), (r, key)
