"""The delta applier over a group of ranks in the port (gloo ranks,
tests/torch_gloo_worker.py's mode "group_delta", one spawned group of
4) against the reference's one-rank ``DeltaApplier`` on the joined tree
(tests/jax_mesh_worker.py's mode "delta"; the reference's sharded
applier fails under this sandbox's jax, ROADMAP "Reference caveats",
and its contract is this: the sharded replica equals the one-rank
replica bit for bit, and every rank reaches the same verdicts).

Each stream is a joined tree of reduced StableLM-3B in the padded layout
that a tensor-parallel trainer publishes (``convert.split_params``'s at
the case's tp; its padding zero), walked by a seeded step and published
by the reference's ``DeltaPublisher`` into a spool: 12 versions, the
payload of version 11 bit-flipped in its file, a snapshot at version 8
beside the one at 0. The replica starts from the version-0 snapshot and
takes one spool file a tick through ``loss:0.4,seed=2`` (versions 1, 3,
9 and 11 arrive): version 1 applies, 3 opens a gap that ends in a
resync from the version-8 snapshot, 9 applies, 11 is dropped as
corrupt. Two models: 6 query and 2 key/value heads with a 510-token
vocabulary (padded at tp 4: 8 and 4 heads, 512 rows), and the reduced
config's own (no padding), each on (1, 4), (2, 2) and (4, 1).

- every verdict and counter equal on every rank and to the reference's;
- after every tick the ranks' trees joined (``convert.join_params``)
  equal the reference's tree bit for bit, and the ranks of a data group
  hold the same bits; the padding stays zero;
- the pinned tree does not change while the live tree moves;
- the launcher's single reader (``GroupChannel``): with a spool file
  written between rank 0's read and the others', every rank receives
  rank 0's payloads, where readers of their own part ways;
- ``_ShardMap``, each rank's map of the joined indices: every real entry
  of a split leaf lands on one rank, at its place in that rank's share,
  a replicated leaf's on every rank, the padding on none.

Ranks meet through a ``file://`` rendezvous under tmp_path."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_threads import one_thread  # noqa: E402,F401
import test_torch_tensor_parallel as tpt  # noqa: E402
import test_torch_world_cp as wcp  # noqa: E402

from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.convert import join_params  # noqa: E402
from repro_torch.core.flatten import tree_items  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.parallel import Parallel  # noqa: E402
from repro_torch.models.specs import leaf_dim, real_entries  # noqa: E402

PADDED = dict(arch="stablelm-3b", heads=[6, 2], vocab=510)
PLAIN = dict(arch="stablelm-3b")
STREAM = dict(versions=12, snapshots=[8], flip=11, k=512, moves=600,
              schedule="loss:0.4,seed=2")
# stream -> (model, tp of its joined layout)
STREAMS = {"padded_tp4": (PADDED, 4), "padded_tp2": (PADDED, 2),
           "padded_tp1": (PADDED, 1), "plain": (PLAIN, 4)}
CASES = {"padded_1x4": ([1, 4], "padded_tp4"),
         "padded_2x2": ([2, 2], "padded_tp2"),
         "padded_4x1": ([4, 1], "padded_tp1"),
         "plain_1x4": ([1, 4], "plain"), "plain_2x2": ([2, 2], "plain"),
         "plain_4x1": ([4, 1], "plain")}
WANT_VERDICTS = ["applied", "gap", "applied", "corrupt"]


def _model(spec: dict):
    cfg = cfgs.reduced_config(cfgs.get_config(spec["arch"]))
    if "heads" in spec:
        cfg = dataclasses.replace(cfg, n_heads=spec["heads"][0],
                                  n_kv_heads=spec["heads"][1])
    if "vocab" in spec:
        cfg = dataclasses.replace(cfg, vocab_size=spec["vocab"])
    return cfg


def _local_shapes(cfg, tp: int) -> list:
    """(path, model rank 0's leaf shape) at tp."""
    class Model(Parallel):
        pass
    Model.tp, Model.tp_on, Model.model_rank = tp, tp > 1, 0
    pal = Model() if tp > 1 else None
    return [(path, tuple(leaf.shape)) for path, leaf in tree_items(
        init_params(cfg, torch.Generator(), "meta", pal))]


def _joined(cfg, tp: int, seed: int):
    """A joined tree in the padded layout at tp (numpy, by ``a/b`` key),
    its padding zero, and its real-entry masks."""
    rng = np.random.default_rng(seed)
    tree, real = {}, {}
    for path, shape in _local_shapes(cfg, tp):
        shape = list(shape)
        dim = leaf_dim(path, len(shape))
        if dim is not None:
            shape[dim] *= tp
        keep = np.ones(shape, bool)
        mask = real_entries(path, tuple(shape), cfg, tp)
        if mask is not None:
            view = [1] * len(shape)
            view[mask[0]] = -1
            keep = np.broadcast_to(mask[1].numpy().reshape(view),
                                   shape).copy()
        key = "/".join(path)
        tree[key] = (rng.standard_normal(shape) * keep).astype(np.float32)
        real[key] = keep
    return tree, real


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Each stream's spool, snapshots and the reference's run of it."""
    tmp = tmp_path_factory.mktemp("streams")
    spec, real_by = {}, {}
    for i, (name, (model, tp)) in enumerate(STREAMS.items()):
        root = tmp / name
        root.mkdir()
        tree, real = _joined(_model(model), tp, seed=40 + i)
        np.savez(root / "tree.npz", **tree)
        np.savez(root / "real.npz", **real)
        real_by[name] = real
        spec[name] = dict(STREAM, root=str(root), tree=str(root / "tree.npz"),
                          real=str(root / "real.npz"), seed=i, model=model)
    ref = wcp.run_reference(tmp, "delta", streams=json.dumps(spec))
    return spec, real_by, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, streams):
    spec, _, _ = streams
    tmp = tmp_path_factory.mktemp("ranks")
    race = tmp / "race"
    (race / "source").mkdir(parents=True)
    src = spec["plain"]["root"] + "/source"
    import os
    import shutil
    for fname in sorted(os.listdir(src))[:3]:
        shutil.copy(os.path.join(src, fname), race / "source")
    cases = {name: dict(mesh=mesh, stream=stream)
             for name, (mesh, stream) in CASES.items()}
    return tpt._spawn_ranks(tmp, "group_delta", 4, streams=json.dumps(spec),
                            cases=json.dumps(cases), race_root=str(race))


def _joined_at(ranks, name: str, mesh, tick: str) -> dict:
    """The ranks of data index 0 joined over the model group, by key."""
    model = mesh[1]
    prefix = f"{name}_{tick}/"
    trees = []
    for m in range(model):
        out = ranks[m]
        trees.append({tuple(key[len(prefix):].split("/")):
                      torch.from_numpy(val) for key, val in out.items()
                      if key.startswith(prefix)})
    from repro_torch.core.flatten import tree_from_items
    joined = join_params([tree_from_items(t.items()) for t in trees])
    return {"/".join(path): leaf.numpy() for path, leaf in tree_items(joined)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_group_applier_matches_the_one_rank_applier(streams, ranks, name):
    """Verdicts, counters, versions and the joined tree after every tick
    equal the reference's one-rank applier's, on every rank; the ranks
    of a data group hold the same bits; the padding stays zero; the
    pinned tree is unchanged."""
    spec, real_by, ref = streams
    mesh, stream = CASES[name]
    want_verdicts = ref[f"{stream}_verdicts"].tolist()
    assert want_verdicts == WANT_VERDICTS
    want_metrics = json.loads(str(ref[f"{stream}_metrics"]))
    assert want_metrics["param_version"] == 9
    assert want_metrics["resyncs"] == 1
    for r, out in enumerate(ranks):
        assert not bool(out["jax_imported"])
        assert out[f"{name}_verdicts"].tolist() == want_verdicts, r
        assert json.loads(str(out[f"{name}_metrics"])) == want_metrics, r
        assert bool(out[f"{name}_pinned_unchanged"]), r
        same = ranks[r % mesh[1]]
        for key, val in out.items():
            if key.startswith(f"{name}_tick") or \
                    key.startswith(f"{name}_final/"):
                assert np.array_equal(val, same[key]), (key, r)
    ticks = STREAM["versions"]
    for t in range(ticks):
        assert int(ranks[0][f"{name}_version_{t}"]) == \
            int(ref[f"{stream}_version_{t}"]), t
        got = _joined_at(ranks, name, mesh, f"tick{t}")
        for key, val in got.items():
            assert np.array_equal(val, ref[f"{stream}_tick{t}/{key}"]), \
                (t, key)
    got = _joined_at(ranks, name, mesh, "final")
    for key, val in got.items():
        assert np.array_equal(val, ref[f"{stream}_final/{key}"]), key
        assert not np.any(val[~real_by[stream][key]]), key


def test_single_reader_gives_every_rank_rank_0s_payloads(ranks):
    """A spool file written between rank 0's read and the others': the
    group channel hands every rank what rank 0 read, one file a read;
    readers of their own see the new file on the later ranks at once."""
    group = [json.loads(str(out["race_group"])) for out in ranks]
    own = [json.loads(str(out["race_own"])) for out in ranks]
    assert all(g == group[0] for g in group)
    assert [len(batch) for batch in group[0]] == [1, 1, 1]
    assert own[0] == group[0]
    assert all(o != own[0] for o in own[1:])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", ["padded", "plain"])
def test_shard_map_places_every_joined_entry(model, tp):
    """Each rank's map of the joined flat indices: a real entry of a split
    leaf on exactly one rank, at the place ``convert.split_leaf`` gives
    it there; a replicated leaf's on every rank; the padding on none."""
    from repro_torch.convert import split_leaf
    from repro_torch.serve.delta import _ShardMap
    cfg = _model(PADDED if model == "padded" else PLAIN)
    tree, real = _joined(cfg, tp, seed=7)
    for path, shape in _local_shapes(cfg, tp):
        key = "/".join(path)
        joined = torch.from_numpy(tree[key])
        lin = torch.arange(joined.numel())
        owners = torch.zeros(joined.numel(), dtype=torch.int64)
        for rank in range(tp):
            smap = _ShardMap(path, shape, tp, rank, cfg)
            local = smap.local(lin)
            mine = local < smap.numel
            owners += mine
            part = split_leaf(path, joined, tp, rank).reshape(-1)
            assert torch.equal(part[local[mine]], joined.reshape(-1)[mine])
        keep = torch.from_numpy(real[key].reshape(-1))
        want = tp if leaf_dim(path, len(shape)) is None else 1
        assert torch.equal(owners[keep], torch.full_like(owners[keep], want))
        assert not bool(owners[~keep].any()), key
