"""The port's delta broadcast (``repro_torch.serve.delta``) and channel
fault schedules against the reference's ``repro.serve.delta`` and
``repro.core.faults``, on the CPU.

Bitwise against the reference (its side under ``jax.jit`` where it jits):
the checksum (k up to 892,032), ``payload_health`` and ``verify``, the
publisher's payloads and mirror in fp32 and bf16 leaves, the applier's
verdicts and held tree under each channel fault kind, the channel
decisions, threefry's split and randint, and spools crossing packages.
Then the contracts restated by direct calls: stale, gap and resync,
strict apply, non-finite payloads, the version floor, the transports, the
wire helpers, the int32 index limit, decode on a pinned tree while
applies land, and the launchers end to end. The inputs are numpy arrays
drawn from seeds; the reference's red ``test_invariant_under_corruption``
is not an oracle here: its run is replayed and its own verdicts held.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.serve import delta as jd  # noqa: E402
from repro_torch.core import faults, threefry  # noqa: E402
from repro_torch.core.flatten import (TreeFlattener, tree_leaves,  # noqa: E402
                                      tree_map)
from repro_torch.serve import delta as td  # noqa: E402


def _np_tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.normal(size=(16, 8))).astype(np.float32),
            "nested": {"b": (scale * rng.normal(size=11)).astype(np.float32)},
            "head": (scale * rng.normal(size=(5, 5))).astype(np.float32)}


def _walks(seed: int, steps: int, scale: float = 0.05) -> list:
    """A trainer's params after each of ``steps`` steps (numpy fp32)."""
    cur, out = _np_tree(seed), []
    for t in range(steps):
        noise = _np_tree(1000 + seed * 97 + t, scale)
        cur = jax.tree_util.tree_map(np.add, cur, noise)
        out.append(cur)
    return out


def _jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype),
                                  tree)


def _torch(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(dtype),
                                  tree)


def _bits(leaf) -> np.ndarray:
    """A leaf's bit pattern as unsigned integers (fp32 or bf16)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy().view(np.uint32)
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _assert_bitwise(port_tree, ref_tree, msg=""):
    got = tree_leaves(port_tree)
    want = jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w)), msg


def _clone(tree):
    return tree_map(lambda l: l.detach().clone(), tree)


def _payload(version=1, k=6, j=100, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=k).astype(np.float32)
    idx = np.sort(rng.choice(j, size=k, replace=False)).astype(np.int32)
    return td.DeltaPayload.stamp(version, vals, idx, k, j)


# ---------------------------------------------------------------------------
# Bitwise against the reference
# ---------------------------------------------------------------------------

_REF_CHECKSUM = jax.jit(jd.payload_checksum, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("k,version,count,j", [
    (0, 1, 0, 10), (1, 7, 1, 2), (6, 3, 6, 100),
    (1000, 2 ** 32 + 5, 999, 2 ** 40 + 17),
    (892_032, 5, 892_032, 892_032_000)])
def test_checksum_matches_reference(k, version, count, j):
    rng = np.random.default_rng(k)
    vals = rng.normal(size=k).astype(np.float32)
    vals[: k // 7] = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-45,
                               -3e38] * (k // 49 + 1), np.float32)[: k // 7]
    idx = rng.integers(-2 ** 31, 2 ** 31, size=k, dtype=np.int64) \
        .astype(np.int32)
    want = int(_REF_CHECKSUM(vals, idx, version, count, j))
    got = td.payload_checksum(torch.from_numpy(vals), torch.from_numpy(idx),
                              version, count, j)
    assert got.shape == () and got.dtype == torch.int64
    assert int(got) == want


def test_checksum_contracts():
    """The reference's contracts: a value-bit flip, an index-bit flip and
    each header field change the sum; swapped entries do too (position
    weights); an out-of-range index with a restamped checksum and a shape
    mismatch are corrupt. Every single-bit flip of every word gets the
    reference's verdict (an odd position's weight is even, so a flip of
    its top bits can go unseen, in both packages)."""
    p = _payload()
    ref = jd.DeltaPayload(p.version, p.values.numpy(), p.indices.numpy(),
                          p.count, p.j, p.checksum)
    assert p.verify() == ref.verify() == "ok"
    for word in range(6):
        for bit in range(32):
            v = p.values.clone()
            v.view(torch.int32)[word] ^= np.int32(np.uint32(1 << bit)
                                                  .view(np.int32)).item()
            got = dataclasses.replace(p, values=v).verify()
            assert got == dataclasses.replace(ref, values=v.numpy()).verify()
    v = p.values.clone()
    v.view(torch.int32)[2] ^= 1 << 13
    assert dataclasses.replace(p, values=v).verify() == "corrupt"
    i = p.indices.clone()
    i[3] ^= 1 << 2
    assert dataclasses.replace(p, indices=i).verify() == "corrupt"
    for field, delta in (("version", 1), ("count", -1), ("j", 1)):
        bad = dataclasses.replace(p, **{field: getattr(p, field) + delta})
        assert bad.verify() == "corrupt"
    v2 = p.values.clone()
    v2[[0, 1]] = v2[[1, 0]]
    assert dataclasses.replace(p, values=v2).verify() == "corrupt"
    p50 = _payload(j=50)
    i = p50.indices.clone()
    i[0] = 50
    assert td.DeltaPayload.stamp(p50.version, p50.values, i, p50.count,
                                 p50.j).verify() == "corrupt"
    assert dataclasses.replace(p, values=p.values[:3]).verify() == "corrupt"


def _health_cases():
    """(values, indices, checksum, version, count, j) of every verdict."""
    rng = np.random.default_rng(3)
    vals = rng.normal(size=9).astype(np.float32)
    idx = np.sort(rng.choice(64, 9, replace=False)).astype(np.int32)
    csum = int(_REF_CHECKSUM(vals, idx, 2, 9, 64))
    flipped = vals.copy()
    flipped.view(np.uint32)[4] ^= 1 << 20
    nan = vals.copy()
    nan[2] = np.nan
    inf = vals.copy()
    inf[0] = np.inf
    far = idx.copy()
    far[-1] = 64
    neg = idx.copy()
    neg[0] = -1
    cases = [(vals, idx, csum, 2, 9, 64), (flipped, idx, csum, 2, 9, 64),
             (vals, idx, csum, 3, 9, 64), (vals, idx, csum + 1, 2, 9, 64)]
    for v, i, count in ((nan, idx, 9), (inf, idx, 9), (vals, far, 9),
                        (vals, neg, 9), (vals, far, 8), (vals, idx, 20),
                        (vals, neg, 0)):
        cases.append((v, i, int(_REF_CHECKSUM(v, i, 2, count, 64)), 2, count,
                      64))
    return cases


def test_health_and_verify_match_reference():
    health = jax.jit(jd.payload_health, static_argnums=(3, 4, 5))
    verdicts = []
    for vals, idx, csum, version, count, j in _health_cases():
        want = [bool(x) for x in health(vals, idx, np.uint32(csum), version,
                                        count, j)]
        got = td.payload_health(torch.from_numpy(vals),
                                torch.from_numpy(idx), csum, version, count,
                                j)
        assert [bool(x) for x in got] == want
        ref = jd.DeltaPayload(version, vals, idx, count, j, csum).verify()
        port = td.DeltaPayload(version, torch.from_numpy(vals),
                               torch.from_numpy(idx), count, j,
                               csum).verify()
        assert port == ref
        verdicts.append(port)
    assert set(verdicts) == {"ok", "corrupt", "nonfinite"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_publisher_matches_reference(dtype):
    """Indices, values, checksum and the mirror at every version; version
    1 publishes the unmoved params (every difference 0, so lax.top_k's
    tie order decides what ships), and in bf16 many differences tie."""
    base = _np_tree(0)
    steps = [base] + _walks(0, 7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jd.DeltaPublisher(_jax(base, jdt), k=20)
    port = td.DeltaPublisher(_torch(base, tdt), k=20, record_history=True)
    for t, cur in enumerate(steps):
        want = ref.publish(_jax(cur, jdt))
        got = port.publish(_torch(cur, tdt))
        assert got.version == want.version == t + 1
        assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
        assert np.array_equal(got.values.numpy().view(np.uint32),
                              np.asarray(want.values).view(np.uint32))
        assert (got.count, got.j, got.checksum) == \
            (want.count, want.j, want.checksum)
        _assert_bitwise(port.published, ref.published, f"v{t + 1}")
        _assert_bitwise(port.params_at(t + 1), ref.published)
    assert port.published["w"].dtype == tdt


def _scenario(D, F, params0, walks, spec, snap, convert, k=24,
              snap_every=8, oracle=None):
    """The reference's fault-trace run (tests/test_serving_delta.py's
    ``_run_faulty``) on package D: publish each step through a send-side
    FaultyChannel, snapshot every ``snap_every`` versions, drain, resync
    after a gap; then flush, a final snapshot, a last resync and drain.
    Returns every verdict, held version and held tree."""
    pub = D.DeltaPublisher(params0, k=k, **({} if oracle is None
                                            else {"record_history": True}))
    app = D.DeltaApplier(params0)
    chan = D.FaultyChannel(D.MemoryChannel(), F.parse_channel_schedule(spec))
    D.write_snapshot(snap, params0, 0)
    trace = []
    for cur in walks:
        chan.send(pub.publish(convert(cur)))
        if pub.version % snap_every == 0:
            pub.write_snapshot(snap)
        verdicts = D.drain(chan, app)
        resync = bool(app.needs_resync and app.can_resync(snap))
        if resync:
            app.resync_from(snap)
        if oracle is not None:
            oracle(app, pub)
        trace.append((verdicts, app.version, resync, app.params))
    flushed = [app.offer(p) for p in chan.flush()]
    pub.write_snapshot(snap)
    resync = bool(app.needs_resync and app.can_resync(snap))
    if resync:
        app.resync_from(snap)
    tail = D.drain(chan, app)
    return {"trace": trace, "flushed": flushed, "end_resync": resync,
            "tail": tail, "version": app.version, "pub": pub.version,
            "counters": dict(app.counters), "chan": dict(chan.counters),
            "held": app.params}


@pytest.mark.parametrize("spec", ["loss:0.4,seed=2", "corrupt:0.4,seed=3",
                                  "reorder:3,seed=4", "stall:5,at=3"])
def test_applier_matches_reference_under_faults(spec, tmp_path):
    """Verdicts, held versions, resyncs, counters and the held tree at
    every step equal the reference's; and the port holds, at each step,
    the publisher's mirror at the held version bit for bit."""
    walks = _walks(8, 25)
    params0 = _np_tree(8)

    def oracle(app, pub):
        _assert_bitwise(app.params, pub.params_at(app.version))

    ref = _scenario(jd, jfaults, _jax(params0), walks, spec,
                    str(tmp_path / "ref"), _jax)
    port = _scenario(td, faults, _torch(params0), walks, spec,
                     str(tmp_path / "port"), _torch, oracle=oracle)
    for t, (got, want) in enumerate(zip(port["trace"], ref["trace"])):
        assert got[:3] == want[:3], (spec, t)
        _assert_bitwise(got[3], want[3], f"{spec} step {t}")
    for key in ("flushed", "end_resync", "tail", "version", "pub",
                "counters", "chan"):
        assert port[key] == ref[key], (spec, key)
    _assert_bitwise(port["held"], ref["held"])
    kind = spec.split(":")[0]
    if kind == "corrupt":
        # the reference's own end state: the last version was corrupted,
        # no later one shows the gap, the replica stays one behind
        assert (port["version"], port["pub"]) == (24, 25)
        assert port["counters"]["dropped_corrupt"] == \
            port["chan"]["corrupted"] > 0
    else:
        assert port["version"] == port["pub"] == 25
    if kind == "loss":
        assert port["counters"]["gaps_detected"] > 0
        assert port["counters"]["resyncs"] > 0
    if kind == "stall":
        assert port["counters"]["applied"] == 25
        assert port["counters"]["gaps_detected"] == 0


KIND_DECISION = {"loss": "channel_drops", "corrupt": "channel_corrupts",
                 "reorder": "channel_delay", "stall": "channel_stalled"}


@pytest.mark.parametrize("seed", [0, 2, 11])
def test_channel_decisions_match_reference(seed):
    versions = np.arange(201, dtype=np.int32)
    for spec in (f"loss:0.4,seed={seed}", f"corrupt:0.25,seed={seed}",
                 f"reorder:{seed + 1},seed={seed}",
                 f"stall:{seed + 1},every={seed + 5},at={seed}"):
        jsched = jfaults.parse_channel_schedule(spec)
        tsched = faults.parse_channel_schedule(spec)
        assert faults.format_channel_schedule(tsched) == \
            jfaults.format_channel_schedule(jsched)
        name = KIND_DECISION[tsched.kind]
        want = np.asarray(jax.jit(jax.vmap(
            lambda v: getattr(jfaults, name)(jsched, v)))(versions))
        got = [int(getattr(faults, name)(tsched, int(v))) for v in versions]
        assert np.array_equal(want.astype(np.int64), got), (spec, name)
        for other in set(KIND_DECISION.values()) - {name}:
            assert int(getattr(faults, other)(tsched, 7)) == 0


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1])
def test_split_and_randint_match_jax(seed):
    jkey, tkey = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    for n in (2, 3):
        assert np.array_equal(
            np.asarray(jax.random.split(jkey, n)).astype(np.uint32),
            threefry.split(tkey, n).numpy().astype(np.uint32))
    for lo, hi in ((0, 4), (0, 1), (0, 0), (5, 3), (-7, 100), (0, 70_000),
                   (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)):
        for d in range(6):
            jk = jax.random.fold_in(jkey, d)
            tk = threefry.fold_in(tkey, d)
            got = threefry.randint(tk, lo, hi)
            assert got.dtype == torch.int32 and got.shape == ()
            assert int(got) == int(jax.random.randint(jk, (), lo, hi))


def test_spools_cross_packages(tmp_path):
    """A JAX publisher's spool and snapshot apply on a torch replica bit
    for bit, and a torch publisher's on a JAX replica."""
    params0, walks = _np_tree(4), _walks(4, 6)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpub = jd.DeltaPublisher(_jax(params0), k=16)
    tpub = td.DeltaPublisher(_torch(params0), k=16)
    jtx, ttx = jd.SpoolChannel(jroot), td.SpoolChannel(troot)
    jpub.write_snapshot(jroot + "/snapshots")
    tpub.write_snapshot(troot + "/snapshots")
    for cur in walks:
        jtx.send(jpub.publish(_jax(cur)))
        ttx.send(tpub.publish(_torch(cur)))
    params, version = td.read_snapshot(jroot + "/snapshots", _torch(params0))
    treplica = td.DeltaApplier(params, version=version)
    assert td.drain(td.SpoolChannel(jroot), treplica) == ["applied"] * 6
    _assert_bitwise(treplica.params, jpub.published)
    params, version = jd.read_snapshot(troot + "/snapshots", _jax(params0))
    jreplica = jd.DeltaApplier(params, version=version)
    assert jd.drain(jd.SpoolChannel(troot), jreplica) == ["applied"] * 6
    _assert_bitwise(tpub.published, jreplica.params)


# ---------------------------------------------------------------------------
# Contracts restated by direct calls
# ---------------------------------------------------------------------------

def _setup(seed=3, k=20, steps=6):
    params = _torch(_np_tree(seed))
    pub = td.DeltaPublisher(params, k=k, record_history=True)
    walks = [_torch(w) for w in _walks(seed, steps)]
    return params, pub, walks


def test_stale_gap_and_resync(tmp_path):
    params, pub, walks = _setup()
    app = td.DeltaApplier(params)
    snap = str(tmp_path)
    payloads = [pub.publish(w) for w in walks]
    assert app.offer(payloads[0]) == "applied"
    assert app.offer(payloads[0]) == "stale"
    assert app.counters["dropped_stale"] == 1
    before = app.params
    assert app.offer(payloads[2]) == "gap"
    assert app.needs_resync and app.counters["gaps_detected"] == 1
    assert app.params is before
    assert app.offer(payloads[1]) == "resync_pending"
    assert app.offer(payloads[3]) == "resync_pending"
    assert not app.can_resync(snap)
    td.write_snapshot(snap, pub.params_at(1), 1)
    assert not app.can_resync(snap)
    pub.write_snapshot(snap)                    # v6
    assert app.can_resync(snap) and app.resync_from(snap) == 6
    assert (app.version, app.floor, app.needs_resync) == (6, 6, False)
    _assert_bitwise(app.params, pub.params_at(6))
    assert app.offer(payloads[3]) == "stale"
    assert app.offer(pub.publish(_torch(_np_tree(99)))) == "applied"
    _assert_bitwise(app.params, pub.params_at(7))


def test_resync_never_moves_backwards(tmp_path):
    params, pub, walks = _setup(seed=4, steps=3)
    app = td.DeltaApplier(params)
    td.write_snapshot(str(tmp_path), params, 0)
    for w in walks:
        app.offer(pub.publish(w))
    assert app.version == 3
    with pytest.raises(td.DeltaVersionError, match="backwards"):
        app.resync_from(str(tmp_path), step=0)


def test_strict_apply_errors():
    params, pub, walks = _setup(seed=5, steps=2)
    app = td.DeltaApplier(params)
    p1, p2 = pub.publish(walks[0]), pub.publish(walks[1])
    with pytest.raises(td.DeltaVersionError, match="contiguous"):
        app.apply(p2)
    v = p1.values.clone()
    v.view(torch.int32)[0] ^= 1
    with pytest.raises(td.DeltaVersionError, match="corrupt"):
        app.apply(dataclasses.replace(p1, values=v))
    with pytest.raises(td.DeltaVersionError, match="want 164"):
        app.apply(td.DeltaPayload.stamp(1, p1.values, p1.indices, p1.count,
                                        p1.j + 64))
    app.apply(p1)
    app.apply(p2)
    assert app.version == 2


def test_nonfinite_never_reaches_live_params():
    params, pub, walks = _setup(seed=6, steps=2)
    app = td.DeltaApplier(params)
    p1 = pub.publish(walks[0])
    v = p1.values.clone()
    v[0] = float("nan")
    poisoned = td.DeltaPayload.stamp(1, v, p1.indices, p1.count, p1.j)
    before = app.params
    assert app.offer(poisoned) == "nonfinite"
    assert app.counters["dropped_nonfinite"] == 1
    assert app.params is before
    assert all(bool(torch.isfinite(l).all()) for l in tree_leaves(before))
    assert app.offer(pub.publish(walks[1])) == "gap"
    with pytest.raises(td.DeltaVersionError, match="nonfinite"):
        app.apply(poisoned)


def test_version_floor_from_snapshot(tmp_path):
    params, pub, walks = _setup(seed=7, steps=5)
    old = [pub.publish(w) for w in walks]
    pub.write_snapshot(str(tmp_path))           # v5
    restored, version = td.read_snapshot(str(tmp_path), params)
    assert version == 5
    app = td.DeltaApplier(restored, version=version)
    assert app.floor == 5
    for p in old:
        with pytest.raises(td.DeltaVersionError, match="floor"):
            app.apply(p)
    assert app.offer(old[-1]) == "stale"
    app.apply(pub.publish(_torch(_np_tree(70))))
    assert app.version == 6


def test_scatter_is_functional_and_idempotent():
    """A written leaf is a new tensor, an untouched one is shared; the
    same payload twice changes nothing; dead and out-of-range pairs write
    nothing."""
    params = _torch(_np_tree(2))
    flat = TreeFlattener(params)
    vals = torch.linspace(1.0, 2.0, 7)
    idx = torch.tensor([0, 5, 40, 127, 128, 140, 152], dtype=torch.int32)
    once = td.scatter_set_tree(flat, params, vals, idx)
    assert once["w"] is not params["w"]
    assert once["head"] is not params["head"]       # leaves: head, b, w
    assert once["nested"]["b"] is params["nested"]["b"]     # [25, 36)
    assert not torch.equal(once["w"], params["w"])
    _assert_bitwise(td.scatter_set_tree(flat, once, vals, idx), once)
    far = torch.tensor([-1, 164, 3], dtype=torch.int32)
    out = td.scatter_set_tree(flat, params, torch.ones(3), far, count=2)
    for a, b in zip(tree_leaves(out), tree_leaves(params)):
        assert a is b


def test_transports(tmp_path):
    root = str(tmp_path)
    tx, rx = td.SpoolChannel(root), td.SpoolChannel(root)
    ps = [_payload(version=v, seed=v) for v in (1, 2, 3)]
    for p in ps:
        tx.send(p)
    got = rx.recv()
    assert [g.version for g in got] == [1, 2, 3]
    for a, b in zip(ps, got):
        assert b.verify() == "ok"
        assert torch.equal(a.values, b.values)
        assert torch.equal(a.indices, b.indices)
        assert (a.version, a.count, a.j, a.checksum) == \
            (b.version, b.count, b.j, b.checksum)
    assert rx.recv() == []
    td.SpoolChannel(root).send(_payload(version=4, seed=4))
    assert [g.version for g in rx.recv()] == [4]
    mem = td.MemoryChannel()
    for v in (1, 2):
        mem.send(_payload(version=v))
    assert [p.version for p in mem.recv()] == [1, 2] and mem.recv() == []
    # a send-side wrapper flips once; its recv does not flip again
    ch = td.FaultyChannel(td.MemoryChannel(), faults.parse_channel_schedule(
        "corrupt:0.999,seed=1"))
    ch.send(_payload(version=1))
    (got,) = ch.recv()
    assert got.verify() == "corrupt"


def test_wire_helpers_and_schedule_surface():
    assert td.delta_wire_bytes(1024) == 1024 * 8 + 24
    assert td.delta_wire_bytes(892_032) == 7_136_280
    assert td.resync_bytes(10_000) == 40_024
    assert td.resync_equiv_deltas(892_032_000, 892_032) == \
        jd.resync_equiv_deltas(892_032_000, 892_032)
    assert _payload(k=6).wire_bytes() == 72
    for spec in ("loss:0.3,seed=5", "corrupt:0.01,seed=0",
                 "reorder:4,seed=2", "stall:10,every=50,at=20"):
        s = faults.parse_channel_schedule(spec)
        assert faults.parse_channel_schedule(
            faults.format_channel_schedule(s)) == s
        assert faults.describe_channel(s) == jfaults.describe_channel(
            jfaults.parse_channel_schedule(spec))
    assert faults.parse_channel_schedule("none") is None
    for bad in ("jitter:0.5", "loss:1.0", "loss:-0.1", "reorder:0",
                "stall:0", "stall:10,every=5", "loss:0.1,huh"):
        with pytest.raises(ValueError):
            faults.parse_channel_schedule(bad)


def test_index_limit_raises():
    """J >= 2^31 raises in the publisher and the applier, naming the int32
    index (meta tensors: nothing is allocated)."""
    meta = torch.device("meta")
    big = {"a": torch.empty((1 << 30,), device=meta),
           "b": torch.empty((1 << 30,), device=meta)}
    for make in (lambda: td.DeltaPublisher(big, k=8),
                 lambda: td.DeltaApplier(big)):
        with pytest.raises(ValueError, match="int32"):
            make()
    big["a"] = torch.empty(((1 << 30) - 1,), device=meta)
    assert td.DeltaApplier(big).j == (1 << 31) - 1


def test_pinned_decode_unaffected_by_live_applies():
    """A decode stream on the tree acquire() pinned gives the logits and
    tokens of the same stream with nothing applied, bit for bit, while
    six deltas land between its steps."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import init_params
    from repro_torch.models import transformer as tfm
    cfg = reduced_config(get_config("stablelm-3b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    new = 6

    def run(p, interleave):
        with torch.inference_mode():
            logits, cache = tfm.prefill(p, {"tokens": prompt}, cfg,
                                        max_seq=12 + new)
            toks = []
            for _ in range(new):
                nxt = logits.argmax(-1)[:, None]
                toks.append(nxt)
                logits, cache = tfm.decode_step(p, cache, nxt, cfg)
                interleave()
        return torch.cat(toks, 1), logits

    oracle_toks, oracle_logits = run(params, lambda: None)
    pub = td.DeltaPublisher(params, k=4096)
    app = td.DeltaApplier(_clone(params))
    chan = td.MemoryChannel()
    gen = torch.Generator().manual_seed(2)
    state = {"cur": params}

    def trainer_step():
        state["cur"] = tree_map(
            lambda l: l + 0.5 * torch.randn(l.shape, generator=gen),
            state["cur"])
        chan.send(pub.publish(state["cur"]))
        td.drain(chan, app)

    pinned, pinned_v = app.acquire()
    held = _clone(pinned)
    toks, logits = run(pinned, trainer_step)
    assert pinned_v == 0 and app.version == new
    assert app.counters["applied"] == new
    assert torch.equal(toks, oracle_toks)
    assert torch.equal(logits, oracle_logits)
    for a, b in zip(tree_leaves(pinned), tree_leaves(held)):
        assert torch.equal(a, b)
    assert app.acquire()[1] == new
    assert not torch.equal(app.params["embed"]["tok"], pinned["embed"]["tok"])


def test_launchers_end_to_end(tmp_path, capsys):
    """train --publish-deltas into serve --apply-deltas on the CPU, at
    --smoke: the replica starts from the version-0 snapshot, loses
    versions 2, 4 and 5 to loss:0.4,seed=2, sees the gap at 3, resyncs to
    the final snapshot and ends equal to the trainer's mirror."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.serve.step import delta_applier_from_snapshot
    spool, ckpt = str(tmp_path / "spool"), str(tmp_path / "ckpt")
    args = train_launcher.parse_args(
        ["--arch", "stablelm-3b", "--smoke", "--steps", "5", "--batch", "2",
         "--seq", "16", "--publish-deltas", spool, "--delta-k", "2048",
         "--checkpoint-dir", ckpt, "--fixed-batch", "--device", "cpu"])
    out = train_launcher.train(train_launcher.run_config(args),
                               device="cpu", batch=2, seq=16,
                               fixed_batch=True,
                               **train_launcher.delta_options(args))
    pub = out["publisher"]
    assert pub.version == 5 and pub.k == 2048
    assert all("publish_ms" in rec for rec in out["history"])
    sargs = serve_launcher.parse_args(
        ["--arch", "stablelm-3b", "--smoke", "--batch", "2", "--prompt-len",
         "8", "--new-tokens", "3", "--device", "cpu"])
    run = serve_launcher.run_config(sargs)
    applier, _ = delta_applier_from_snapshot(run, spool + "/snapshots",
                                             "cpu", step=0)
    chan = td.FaultyChannel(td.SpoolChannel(spool),
                            faults.parse_channel_schedule("loss:0.4,seed=2"))
    res = serve_launcher.serve(run, device="cpu", prompt_len=8,
                               new_tokens=3, applier=applier, channel=chan,
                               snap_dir=spool + "/snapshots",
                               log=lambda msg: None)
    m = res["delta"]
    assert res["pinned_version"] == 0 and m["param_version"] == 5
    assert (m["applied"], m["gaps_detected"], m["resyncs"]) == (1, 1, 1)
    assert chan.counters["dropped"] == 3
    for a, b in zip(tree_leaves(applier.params), tree_leaves(pub.published)):
        assert torch.equal(a, b)
    # the launcher's CLI on the same spool: starts at the final snapshot
    assert serve_launcher.main(
        ["--arch", "stablelm-3b", "--smoke", "--batch", "2",
         "--prompt-len", "8", "--new-tokens", "2", "--device", "cpu",
         "--apply-deltas", spool,
         "--delta-fault-schedule", "loss:0.4,seed=2"]) == 0
    text = capsys.readouterr().out
    assert "(snapshot v5)" in text and "live params now v5" in text
    assert "'dropped_stale': 2" in text
