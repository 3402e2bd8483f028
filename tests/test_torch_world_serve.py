"""The port's serving steps over gloo process groups against the
reference's (tests/jax_mesh_worker.py's mode "serve", one subprocess for
the module): reduced Granite-8B with full attention and its sliding
variant (window 8 of a 16-position context, so the ring buffer wraps in
the decode), the same parameters, the prompts' and the fed decode
tokens the same numpy draw (teacher forcing).

- a data-parallel batch of 4 at gloo worlds 2 and 4: the prefill and 4
  decode steps, the logits gathered to (4, V), against the reference's
  ``build_prefill`` / ``build_decode_step`` on a (world, 1) mesh and its
  one-device ``prefill`` / ``decode_step``;
- context-parallel decode at gloo world 4 with batches 1 and 2: a
  one-rank prefill's cache split over the ranks by
  ``shard_decode_cache``, 4 decode steps whose slots lie on two ranks
  (in the sliding variant the ring wraps from rank 3 to rank 0), against
  the reference's context-parallel decode of the same cache put on the
  mesh and its one-device decode;
- a batch, or a context-parallel cache, that the ranks do not split is
  refused with ValueError.

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

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL = ATOL = 1e-5
WINDOW, PROMPT, SEQ, STEPS = 8, 6, 16, 4
DP = [(world, attn) for world in (2, 4) for attn in ("full", "sliding")]
CP = [(batch, attn) for batch in (1, 2) for attn in ("full", "sliding")]


def _case(world, batch, attn, cp):
    return dict(world=world, batch=batch, attn=attn, cp=cp, prompt=PROMPT,
                seq=SEQ)


CASES = {**{f"dp{w}_{a}": _case(w, 4, a, False) for w, a in DP},
         **{f"cp{b}_{a}": _case(4, b, a, True) for b, a in CP}}
# (batch, seq) the builders must refuse over 2 and 4 ranks, then one
# they must take
RAISE = {2: [(3, SEQ), (1, 15), (4, SEQ)], 4: [(6, SEQ), (2, 18), (4, SEQ)]}


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
                OMP_NUM_THREADS="1")


def _tokens():
    return np.random.default_rng(25).integers(
        0, 512, (4, PROMPT + STEPS)).astype(np.int32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reference")
    np.savez(tmp / "inputs.npz", mode="serve", window=WINDOW,
             tokens=_tokens(), cases=json.dumps(CASES))
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "jax_mesh_worker.py"), "4",
         str(tmp / "inputs.npz"), str(tmp / "out.npz")],
        env=_env(), capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    return dict(np.load(tmp / "out.npz"))


def _spawn(tmp, world, reference):
    inp = tmp / "inputs.npz"
    np.savez(inp, window=WINDOW, tokens=_tokens().astype(np.int64),
             init_params=reference["init_params"], cases=json.dumps(CASES),
             raise_cases=np.asarray(RAISE[world]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"),
         "world_serve", str(r), str(world), str(tmp / "rendezvous"),
         str(inp), str(tmp / f"rank{r}.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    return {world: _spawn(tmp_path_factory.mktemp(f"world{world}"), world,
                          reference) for world in (2, 4)}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _same_on_every_rank(ranks, key):
    for r, res in enumerate(ranks):
        assert np.array_equal(res[key], ranks[0][key]), (key, r)


@pytest.mark.parametrize("world,attn", DP)
def test_data_parallel_batch_matches_reference(ranks, reference, world,
                                               attn):
    """Each rank prefills and decodes its rows; the gathered logits are
    the reference mesh's and its one-device serving's."""
    name = f"dp{world}_{attn}"
    res = ranks[world]
    for r, out in enumerate(res):
        assert not bool(out["jax_imported"])
        assert tuple(out[f"{name}_cache_slots"]) == (
            4 // world, WINDOW if attn == "sliding" else SEQ), r
        assert np.array_equal(out[f"{name}_init_slots"],
                              out[f"{name}_cache_slots"])
    _same_on_every_rank(res, f"{name}_prefill")
    _close(res[0][f"{name}_prefill"], reference[f"{name}_mesh_prefill"],
           "prefill vs mesh")
    _close(res[0][f"{name}_prefill"], reference[f"{name}_one_prefill"],
           "prefill vs one device")
    for t in range(STEPS):
        _same_on_every_rank(res, f"{name}_decode_{t}")
        got = res[0][f"{name}_decode_{t}"]
        _close(got, reference[f"{name}_mesh_decode_{t}"], f"step {t} mesh")
        _close(got, reference[f"{name}_one_decode_{t}"], f"step {t} one")


@pytest.mark.parametrize("batch,attn", CP)
def test_context_parallel_decode_matches_reference(ranks, reference, batch,
                                                   attn):
    """The batch stays whole and the cache's slots split over 4 ranks
    (4 a rank, or 2 of the sliding ring's 8): every rank returns the
    same logits, those of the reference's context-parallel decode and
    of its one-device decode."""
    name = f"cp{batch}_{attn}"
    res = ranks[4]
    for r, out in enumerate(res):
        assert tuple(out[f"{name}_cache_slots"]) == (
            batch, (WINDOW if attn == "sliding" else SEQ) // 4), r
        # a zero cache of the layout is the slice of the split one
        assert np.array_equal(out[f"{name}_init_slots"],
                              out[f"{name}_cache_slots"])
        assert f"{name}_prefill" not in out
    for t in range(STEPS):
        _same_on_every_rank(res, f"{name}_decode_{t}")
        got = res[0][f"{name}_decode_{t}"]
        _close(got, reference[f"{name}_mesh_decode_{t}"], f"step {t} mesh")
        _close(got, reference[f"{name}_one_decode_{t}"], f"step {t} one")


@pytest.mark.parametrize("world", [2, 4])
def test_layouts_the_ranks_do_not_split_raise(ranks, world):
    """A batch the ranks do not split, and a context-parallel cache whose
    slots they do not split, raise ValueError; an even split does not."""
    for out in ranks[world]:
        assert out["raises"].tolist() == [True, True, False]
