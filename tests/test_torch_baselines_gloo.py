"""The baselines' per-step sync over gloo worlds of 2, 3 and 4 against
the reference's per-step GradientSync on a mesh of as many host CPU
devices (tests/jax_mesh_worker.py, a process of its own), bitwise: kinds
none and globaltopk with and without participation bits, comm_mode=
"dense" on REGTOP-k, and the simulate and sparse combines, whose mean
over the static world size the compiled reference computes as a multiply
by fp32(1/n) (XLA rewrites the division by a constant; at a world of 3
the two differ). The gradients are dyadic (k * 2^-8, |k| <= 2^10), so
every sum across ranks is exact in any order: gloo's and XLA's orders
of addition cannot show, the scale by 1/n and every local step can.
The simulate combine all-reduces mask * a, which is -0.0 where a < 0 is
not selected: gloo adds such entries to -0.0, the reference's CPU
all-reduce to +0.0, so there g_agg and the dense posterior's copy of it
(g_agg_prev) are compared up to the sign of zero."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

HERE = os.path.dirname(os.path.abspath(__file__))
T, J, SPARSITY, MU = 3, 3 * 4096 + 517, 0.01, 0.5
# name: (SparsifierConfig fields besides sparsity and mu, whether each
# rank passes its participation bit)
CASES = {
    "none": (dict(kind="none"), False),
    "none_elastic": (dict(kind="none"), True),
    "genie": (dict(kind="globaltopk"), False),
    "genie_elastic": (dict(kind="globaltopk"), True),
    "dense_regtopk": (dict(kind="regtopk", comm_mode="dense"), False),
    "simulate_topk": (dict(kind="topk", comm_mode="simulate"), False),
    "sparse_regtopk": (dict(kind="regtopk", pipeline="fused",
                            comm_mode="sparse"), False),
}


def _spawn(tmp_path, world, **data):
    """The port's gloo ranks and the reference's mesh run, side by side."""
    inp = tmp_path / "inputs.npz"
    np.savez(inp, sparsity=SPARSITY, mu=MU, cases=json.dumps(CASES), **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    out = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"),
         "baselines", str(r), str(world), str(tmp_path / "rendezvous"),
         str(inp), str(out[r])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    ref = tmp_path / "reference.npz"
    procs.append(subprocess.Popen(
        [sys.executable, os.path.join(HERE, "jax_mesh_worker.py"),
         str(world), str(inp), str(ref)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(f)) for f in out], dict(np.load(ref))


SIMULATED = ("dense_regtopk", "simulate_topk")


def _bits(x, zero_sign=True):
    x = np.asarray(x)
    if not zero_sign:
        x = x + np.float32(0.0)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


@pytest.mark.parametrize("world", [2, 3, 4])
def test_gloo_baselines_match_reference_mesh(tmp_path, world):
    rng = np.random.default_rng(90 + world)
    grads = (rng.integers(-1024, 1025, (T, world, J))
             * 2.0 ** -8).astype(np.float32)
    parts = rng.random((T, world)) < 0.6
    parts[0] = True
    parts[1, 0] = False                    # someone sits out
    parts[2] = False                       # and everyone at the last step
    ranks, ref = _spawn(tmp_path, world, grads=grads, parts=parts)
    for name, (_, elastic) in CASES.items():
        signed = name not in SIMULATED
        for t in range(T):
            want = ref[f"{name}_g_agg_{t}"]               # (world, J)
            for r, res in enumerate(ranks):
                got = res[f"{name}_g_agg_{t}"]
                assert np.array_equal(_bits(got, signed),
                                      _bits(want[r], signed)), (name, t, r)
                assert np.array_equal(_bits(got),
                                      _bits(ranks[0][f"{name}_g_agg_{t}"]))
                na = float(res[f"{name}_n_active_{t}"])
                assert na == float(ref[f"{name}_n_active_{t}"][r]), (name, t)
                assert na == (parts[t].sum() if elastic else world)
            if elastic and not parts[t].any():
                assert not want.any(), (name, t)
        for r, res in enumerate(ranks):
            assert not bool(res["jax_imported"])
            keys = {k[len(name) + 7:] for k in res
                    if k.startswith(f"{name}_state_")}
            assert keys == {k[len(name) + 7:] for k in ref
                            if k.startswith(f"{name}_state_")}, name
            for key in keys:
                exact = signed or key != "g_agg_prev"
                assert np.array_equal(
                    _bits(res[f"{name}_state_{key}"], exact),
                    _bits(ref[f"{name}_state_{key}"][r], exact)), \
                    (name, r, key)
