"""The port's cost model and bucket auto-tune (``repro_torch.roofline.
analysis``) against the reference's ``repro.roofline.analysis``:

- ``auto_num_buckets`` at the reference's v5e constants (its hardware
  and 5 us latency floor passed in, since the port holds no TPU
  constant) over payloads from 0 to 1e10 and 1 to 64 workers, and the
  reference's own cases (tests/test_fused_configs.py::TestAutoNumBuckets);
- ``roofline_terms`` float for float on the records of
  tests/test_roofline.py, tests/test_elastic.py and
  tests/test_serving_delta.py, and on the streaming and sketch terms;
- ``resolve_num_buckets`` and compress's worker count from omega (a
  tensor omega raises the reference's TypeError text);
- a train step with ``num_buckets=0`` on one rank, bit for bit the step
  with the resolved count written out, its sync bit for bit the
  reference's compiled ``GradientSync`` resolving ``num_buckets=0``;
  and the sync over a gloo group of 2 against the reference's on a mesh
  of 2 host devices, bit for bit (tests/torch_gloo_worker.py's mode
  "baselines", tests/jax_mesh_worker.py's "sync"). In each, the
  collective launch floor is patched in both packages, so that the count
  resolves above 1 at the test's payload: ``COLLECTIVE_LATENCY_S`` in
  the port, the reference's ``auto_num_buckets`` given the same floor and
  the H100's constants (its default is bound when it is defined).

The module runs on one intra-op thread (tests/torch_threads.py): two
runs of the same train step on the CPU's thread pool can differ in the
last bit of a reduction in the backward pass, on one thread they do not."""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import aggregate as jagg  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import sparsify as jsp  # noqa: E402
from repro.roofline import analysis as jan  # noqa: E402
from repro.serve.delta import (delta_wire_bytes, resync_bytes,  # noqa: E402
                               resync_equiv_deltas)
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import aggregate as tagg  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.roofline import analysis as tan  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
V5E = tan.Hardware(jan.HW_V5E.name, jan.HW_V5E.peak_flops_bf16,
                   jan.HW_V5E.hbm_bw, jan.HW_V5E.ici_bw)
V5E_LATENCY = 5e-6
PAYLOADS = [0, 1, 7, 100, 1000, 8191, 8192, 65536, 100_003, 2_280_000,
            10 ** 6, 10 ** 7, 3 * 10 ** 7, 10 ** 8, 10 ** 9, 10 ** 10]
WORKERS = [1, 2, 3, 4, 8, 16, 32, 64]
BASE = dict(mesh={"data": 16, "model": 16}, kind="train", shape="train_4k",
            active_params=3_000_000_000, flops=1e14, bytes_accessed=1e12,
            collective_bytes={"total": 1e11}, hlo_flops=1e14,
            hlo_bytes=8e11, hlo_collective_wire_bytes=2e11)


def test_h100_constants():
    """The datasheet's figures, and a launch floor measured on the card;
    no TPU constant."""
    assert tan.HW_H100 == tan.Hardware("nvidia-h100-sxm", 989.4e12,
                                       3.35e12, 450e9)
    assert tan.MIN_CHUNK_BYTES == jan.MIN_CHUNK_BYTES
    assert tan.MAX_AUTO_BUCKETS == jan.MAX_AUTO_BUCKETS
    assert 0 < tan.COLLECTIVE_LATENCY_S != jan.COLLECTIVE_LATENCY_S
    assert not hasattr(tan, "HW_V5E")


@pytest.mark.parametrize("n", WORKERS)
def test_auto_num_buckets_matches_the_reference(n):
    for payload in PAYLOADS:
        want = jan.auto_num_buckets(payload, n)
        assert tan.auto_num_buckets(payload, n, hw=V5E,
                                    latency_s=V5E_LATENCY) == want, payload
        for hw in (V5E, tan.HW_H100):
            ref_hw = jan.Hardware(hw.name, hw.peak_flops_bf16, hw.hbm_bw,
                                  hw.link_bw)
            for lat in (1e-9, 2e-5, 0.0):
                assert tan.auto_num_buckets(payload, n, hw=hw,
                                            latency_s=lat) == \
                    jan.auto_num_buckets(payload, n, hw=ref_hw,
                                         latency_s=lat), (payload, lat)


def test_auto_num_buckets_cases_of_the_reference():
    """tests/test_fused_configs.py's TestAutoNumBuckets.test_model_shape
    at the reference's constants."""
    auto = functools.partial(tan.auto_num_buckets, hw=V5E,
                             latency_s=V5E_LATENCY)
    assert auto(0, 16) == 1
    assert auto(1000, 4) == 1
    assert auto(2_280_000, 16) > 1
    assert auto(10 ** 9, 64) <= 16


def _records():
    """Records of the reference's tests, the port's keys."""
    straggler = {
        "mesh": {"data": 8, "model": 1}, "kind": "train",
        "shape": "train_4k", "arch": "x", "active_params": 10 ** 9,
        "flops": 1e12, "bytes_accessed": 1e9,
        "collective_bytes": {"total": 4e8},
        "sparse_gather_wire_bytes": 2e8,
        "fault": {"schedule": "iid:0.3,seed=0", "n_active_expected": 5.6,
                  "sparse_gather_wire_bytes_active": 1.4e8}}
    delta = {
        "mesh": {"data": 4, "model": 2}, "kind": "decode",
        "shape": "decode_32k", "active_params": 3_000_000_000,
        "flops": 1e12, "bytes_accessed": 1e11,
        "collective_bytes": {"total": 1e9},
        "delta": {"k": 4096, "wire_bytes": delta_wire_bytes(4096),
                  "resync_bytes": resync_bytes(3_000_000_000),
                  "resync_equiv_deltas": resync_equiv_deltas(
                      3_000_000_000, 4096),
                  "fault": jfaults.describe_channel(
                      jfaults.parse_channel_schedule("loss:0.05"))}}
    return {
        "dominance": dict(BASE),
        "bucketed": dict(BASE, num_buckets=8),
        "bucketed_gather": dict(BASE, num_buckets=4,
                                sparse_gather_wire_bytes=5e10),
        "streamed": dict(BASE, overlap="backward", num_stream_segments=8,
                         sparse_gather_wire_bytes=5e10),
        "sketch": dict(BASE, sketch_allreduce_bytes=3e9,
                       sparse_gather_wire_bytes=1e9),
        "straggler": straggler,
        "delta": delta,
        "delta_clean": dict(delta, delta=dict(delta["delta"], fault=None)),
        "prefill": dict(BASE, kind="prefill", shape="prefill_32k"),
        "long": dict(BASE, kind="decode", shape="long_500k"),
        "no_hlo": {key: val for key, val in BASE.items()
                   if not key.startswith("hlo_")},
    }


@pytest.mark.parametrize("name", list(_records()))
def test_roofline_terms_match_the_reference(name):
    rec = _records()[name]
    want = jan.roofline_terms(rec, jan.HW_V5E)
    assert tan.roofline_terms(rec, V5E) == want
    assert tan.analyze_record(rec, V5E)["roofline"] == want
    assert tan.format_table([dict(rec, arch="a", shape=rec["shape"])],
                            V5E) == jan.format_table(
        [dict(rec, arch="a", shape=rec["shape"])], jan.HW_V5E)


def test_overlap_and_model_flops_match_the_reference():
    for args in ((4.0, 1.0, 1), (4.0, 1.0, 4), (1.0, 4.0, 7), (0.0, 3.0, 2)):
        assert tan.pipelined_overlap_s(*args) == jan.pipelined_overlap_s(*args)
        assert tan.comm_behind_backward_s(*args) == \
            jan.comm_behind_backward_s(*args)
    for kind in ("train", "prefill", "decode"):
        assert tan.model_flops(kind, 1e9, 8, 128) == \
            jan.model_flops(kind, 1e9, 8, 128)


def _patch(monkeypatch, latency: float) -> None:
    """The launch floor of both packages at ``latency``, the H100's
    constants in both."""
    monkeypatch.setattr(tan, "COLLECTIVE_LATENCY_S", latency)
    h = tan.HW_H100
    monkeypatch.setattr(jan, "auto_num_buckets", functools.partial(
        jan.auto_num_buckets, hw=jan.Hardware(h.name, h.peak_flops_bf16,
                                              h.hbm_bw, h.link_bw),
        latency_s=latency))


def test_resolve_num_buckets_matches_the_reference(monkeypatch):
    _patch(monkeypatch, 1e-8)
    for fields in (dict(kind="regtopk", pipeline="fused", sparsity=0.05),
                   dict(kind="dgc", pipeline="fused", sparsity=0.2,
                        selector="histogram"),
                   dict(kind="sketchtopk", pipeline="fused", sparsity=0.1),
                   dict(kind="topk", pipeline="reference", sparsity=0.3)):
        for j in (12_345, 1 << 18, 3_000_001):
            for n in (1, 2, 8):
                tcfg = tbase.SparsifierConfig(num_buckets=0,
                                              comm_mode="sparse", **fields)
                jcfg = jbase.SparsifierConfig(**dataclasses.asdict(tcfg))
                got = tsp.resolve_num_buckets(tcfg, j, n)
                assert got == jsp.resolve_num_buckets(jcfg, j, n)
                assert tsp.resolve_num_buckets(dataclasses.replace(
                    tcfg, num_buckets=got), j, n) == got
    assert tsp._workers_from_omega(0.25) == jsp._workers_from_omega(0.25)
    assert tsp._workers_from_omega(0) == jsp._workers_from_omega(0) == 1
    with pytest.raises(TypeError) as want:
        jax.jit(jsp._workers_from_omega)(0.5)
    with pytest.raises(TypeError) as got:
        tsp._workers_from_omega(torch.tensor(0.5))
    assert str(got.value) == str(want.value)


def _dyadic(rng, shape):
    return (rng.integers(-1024, 1025, shape) * 2.0 ** -8).astype(np.float32)


def test_auto_buckets_one_rank_step_and_sync(monkeypatch):
    """Reduced StableLM-3B, REGTOP-k fused with sparse comm at sparsity
    0.1, Adam: 3 steps with ``num_buckets=0`` resolve to 3 buckets and
    hold bit for bit what the same steps hold with ``num_buckets=3``
    written out (B1 and B2 launched a bucket a step); the sync's own
    ``num_buckets=0`` on dyadic gradients over 3 steps is bit for bit
    the reference's jitted GradientSync on a one-device mesh."""
    from repro_torch.train.step import (auto_num_buckets_for_run,
                                        build_train_step, init_train_state)
    _patch(monkeypatch, 1e-8)
    model = tbase.reduced_config(tbase.get_config("stablelm-3b"))
    sp = tbase.SparsifierConfig(kind="regtopk", pipeline="fused",
                                comm_mode="sparse", sparsity=0.1, mu=0.5,
                                num_buckets=0)
    runs = [tbase.RunConfig(model=model, shape=tbase.SHAPES["train_4k"],
                            sparsifier=dataclasses.replace(sp, num_buckets=nb),
                            optimizer=tbase.OptimizerConfig(kind="adam",
                                                            lr=1e-3))
            for nb in (0, 3)]
    nb, j, dp = auto_num_buckets_for_run(runs[0])
    assert (nb, dp) == (3, 1) and j == model.param_count()
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, 512, (4, 32)))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    finals = []
    for run in runs:
        step = build_train_step(run, "cpu")
        assert step.gsync.cfg.num_buckets == 3
        assert step.gsync.requested.num_buckets == run.sparsifier.num_buckets
        state = init_train_state(run, "cpu")
        for _ in range(3):
            state, metrics = step(state, batch)
        finals.append((state, metrics))
    (a, ma), (b, mb) = finals
    for x, y in zip(*(tbase_leaves(s) for s in (a, b))):
        assert torch.equal(x, y)
    for key in ma:
        assert torch.equal(ma[key], mb[key]), key
    # the sync against the reference's on the same gradients
    jn = 1 << 17
    cfg = tbase.SparsifierConfig(kind="regtopk", pipeline="fused",
                                 comm_mode="sparse", sparsity=0.25, mu=0.5,
                                 num_buckets=0)
    grads = _dyadic(rng, (3, jn))
    sync = tagg.GradientSync(cfg)
    st = tsp.init_state(cfg, jn, "cpu")
    jcfg = jbase.SparsifierConfig(**dataclasses.asdict(cfg))
    mesh = jax.make_mesh((1,), ("data",))
    tmap = jax.tree_util.tree_map

    def f(g, s):
        g_agg, new = jagg.GradientSync(jcfg, ("data",))(
            tmap(lambda x: x[0], s), g[0])
        return g_agg[None], tmap(lambda x: x[None], new)
    jst = tmap(lambda x: x[None], jsp.init_state(jcfg, jn))
    spec = tmap(lambda _: P("data"), jst)
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P("data"), spec),
                               out_specs=(P("data"), spec), check_vma=False))
    with mesh:
        for t in range(3):
            g_agg, st = sync(st, torch.from_numpy(grads[t]))
            jg, jst = fn(jnp.asarray(grads[t][None]), jst)
            assert np.array_equal(g_agg.numpy().view(np.int32),
                                  np.asarray(jg)[0].view(np.int32)), t
    assert sync.cfg.num_buckets == tsp.resolve_num_buckets(cfg, jn, 1) > 1
    for key, val in jst.items():
        assert np.array_equal(st[key].numpy().view(np.int32),
                              np.asarray(val)[0].view(np.int32)), key


def tbase_leaves(state):
    from repro_torch.core.flatten import tree_leaves
    return [x.detach() for tree in (state.params, state.opt, state.ef)
            for x in tree_leaves(tree)]


def test_auto_buckets_sync_over_a_gloo_group_of_2(tmp_path):
    """The chunked sparse all-gather with ``num_buckets=0`` over a gloo
    group of 2 (each rank resolving the count from J and the group's
    size) against the reference's GradientSync on a mesh of 2 host
    devices resolving its own, on dyadic gradients over 3 steps: g_agg
    and every state leaf bit for bit, and the same as the port's run
    with the resolved count written out."""
    world, jn, latency = 2, 1 << 16, 5e-9
    h = tan.HW_H100
    # k = J / 4 pairs a rank: 2 x 16,384 x 8 B gathered
    nb = tan.auto_num_buckets(jn // 4, world, latency_s=latency)
    assert nb == 3
    cases = {"auto": [dict(kind="regtopk", pipeline="fused",
                           comm_mode="sparse", num_buckets=0), False],
             "written": [dict(kind="regtopk", pipeline="fused",
                              comm_mode="sparse", num_buckets=nb), False]}
    grads = _dyadic(np.random.default_rng(12), (3, world, jn))
    inp = tmp_path / "inputs.npz"
    np.savez(inp, sparsity=0.25, mu=0.5, cases=json.dumps(cases),
             grads=grads, parts=np.ones((3, world), bool),
             auto_buckets=json.dumps([h.name, h.peak_flops_bf16, h.hbm_bw,
                                      h.link_bw, latency]))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               OMP_NUM_THREADS="1")
    out = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_gloo_worker.py"),
         "baselines", str(r), str(world), str(tmp_path / "rendezvous"),
         str(inp), str(out[r])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    ref = tmp_path / "reference.npz"
    procs.append(subprocess.Popen(
        [sys.executable, os.path.join(HERE, "jax_mesh_worker.py"),
         str(world), str(inp), str(ref)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks, want = [dict(np.load(f)) for f in out], dict(np.load(ref))
    for r, res in enumerate(ranks):
        assert not bool(res["jax_imported"])
        assert int(res["auto_num_buckets"]) == nb
        keys = [k[5:] for k in res if k.startswith("auto_")
                and k != "auto_num_buckets"]
        assert any(k.startswith("state_") for k in keys)
        for key in keys:
            got = _bits(res[f"auto_{key}"])
            assert np.array_equal(got, _bits(res[f"written_{key}"])), \
                (r, key)
            assert np.array_equal(got, _bits(want[f"auto_{key}"][r])), \
                (r, key)


def _bits(x):
    """fp32 and uint32 as their int32 bits (the port keeps uint32
    indices as int32 views of the same bits)."""
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def test_launcher_logs_the_auto_tuned_count(monkeypatch, capsys):
    """``--num-buckets 0`` trains and logs the reference's line,
    ``[train] num_buckets=0 -> auto-tuned N (J_local=..., dp=1)``, with
    N the count the step runs."""
    from repro_torch.launch import train as launcher
    monkeypatch.setattr(tan, "COLLECTIVE_LATENCY_S", 1e-8)
    launcher.main(["--arch", "stablelm-3b", "--smoke", "--steps", "2",
                   "--comm", "sparse", "--pipeline", "fused",
                   "--num-buckets", "0", "--sparsity", "0.1",
                   "--fixed-batch", "--device", "cpu", "--batch", "2",
                   "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] num_buckets=0 -> auto-tuned 3 (J_local=460,032, dp=1)" \
        in out, out
    assert "step     1 loss" in out
