"""The chunked sparse all-gather over gloo worlds of 1, 2 and 4 against
the reference's per-step GradientSync on a mesh of as many host CPU
devices (tests/jax_mesh_worker.py, a process of its own), bitwise: the
packed pairs in num_buckets chunks on the bf16 wire, chunk b + 1's
all-gather issued before chunk b's scatter-adds, with the bf16 error
state, the fused histogram selector's pads, elastic participation under
both combines, and the degenerate case of no more pairs than chunks.
The gradients are dyadic (k * 2^-8, |k| <= 2^10): their ties drive the
trims through their fallbacks, and every sum across ranks is exact, so
no order of addition can show; the wire's rounding to bf16 can."""
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
FUSED = dict(pipeline="fused", comm_mode="sparse")
# name: (SparsifierConfig fields besides sparsity and mu, whether each
# rank passes its participation bit)
CASES = {
    "regtopk_chunks_bf16_wire": (dict(kind="regtopk", num_buckets=4,
                                      wire_dtype="bfloat16", **FUSED),
                                 False),
    "dgc_hist_bf16_support": (dict(kind="dgc", num_buckets=3,
                                   selector="histogram",
                                   ef_dtype="bfloat16",
                                   wire_dtype="bfloat16", err_decay=0.9,
                                   combine="support", **FUSED), True),
    "topk_k_below_buckets": (dict(kind="topk", k=3, num_buckets=4,
                                  wire_dtype="bfloat16", **FUSED), True),
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


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


@pytest.mark.parametrize("world", [1, 2, 4])
def test_chunked_bf16_wire_matches_reference_mesh(tmp_path, world):
    rng = np.random.default_rng(40 + world)
    grads = (rng.integers(-1024, 1025, (T, world, J))
             * 2.0 ** -8).astype(np.float32)
    parts = rng.random((T, world)) < 0.6
    parts[0] = True
    parts[1, 0] = False                    # someone sits out
    ranks, ref = _spawn(tmp_path, world, grads=grads, parts=parts)
    for name, (_, elastic) in CASES.items():
        for t in range(T):
            want = ref[f"{name}_g_agg_{t}"]               # (world, J)
            for r, res in enumerate(ranks):
                got = res[f"{name}_g_agg_{t}"]
                assert np.array_equal(_bits(got), _bits(want[r])), \
                    (name, t, r)
                na = float(res[f"{name}_n_active_{t}"])
                assert na == float(ref[f"{name}_n_active_{t}"][r]), (name, t)
                assert na == (parts[t].sum() if elastic else world)
        for r, res in enumerate(ranks):
            assert not bool(res["jax_imported"])
            keys = {k[len(name) + 7:] for k in res
                    if k.startswith(f"{name}_state_")}
            assert keys == {k[len(name) + 7:] for k in ref
                            if k.startswith(f"{name}_state_")}, name
            for key in keys:
                got, want = res[f"{name}_state_{key}"], \
                    ref[f"{name}_state_{key}"][r]
                # idx_prev: the port's int32 view of the uint32 bits
                assert got.dtype.itemsize == want.dtype.itemsize, (name, key)
                assert np.array_equal(_bits(got), _bits(want)), \
                    (name, r, key)
