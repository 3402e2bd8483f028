"""Versioned sparse delta broadcast: learning while serving (the port of
``repro.serve.delta``, in its wire and spool formats).

The trainer publishes its post-step parameter movement as an exactly-k
sparse payload; serving replicas apply it as an O(k) scatter into their
live parameters between decode steps. The channel between them is lossy
by contract:

- **Versioning.** Each payload carries a monotonic ``param_version``. A
  replica applies version v+1 only on top of v: stale arrivals are
  dropped (counted), a gap sets ``needs_resync`` and the replica refuses
  to advance until a full snapshot at a newer version is restored.
- **Scatter-set.** ``values[i]`` is the new absolute value at flat index
  ``indices[i]`` (TreeFlattener order), so publisher and replica run the
  same :func:`scatter_set_tree` and a replica at version v equals the
  publisher's mirror at v bit for bit, in every leaf dtype.
- **Publisher-side error feedback.** The publisher mirrors what a
  caught-up replica holds and ships the top-k of ``|true - mirror|``;
  what did not fit stays in the next step's difference.
- **Health guards.** A position-weighted uint32 checksum over the bit
  patterns; checksum-failing and non-finite payloads are dropped on the
  ``dropped_corrupt`` / ``dropped_nonfinite`` counters.
- **In-flight consistency.** Applies are functional: a leaf that a
  payload writes is cloned first, the others are shared. A decode stream
  pins ``(params, version)`` from :meth:`DeltaApplier.acquire` and reads
  those tensors unchanged while the live tree moves on, for up to one
  copy of the parameters per apply.

A trainer under tensor parallelism publishes the parameters joined over
its model group (``train.step.joined_params``: the reference's global
tree, as its publisher sees the mesh-assembled arrays), so payloads,
snapshots and replicas keep the one-rank layout. That tree is gathered a
leaf at a time into host memory, and the publisher's mirror and its
difference vector live there with it: no card holds a global copy.

Payload indices are int32, as the reference's, so J must stay below 2^31:
the publisher and the applier raise for a larger model instead of
wrapping. Transports: :class:`MemoryChannel`, :class:`SpoolChannel` (the
reference's file names and npz keys: a spool written by either package
applies in the other), :class:`FaultyChannel` (the seeded
``core.faults`` channel schedules) and :class:`GroupChannel` (one reader
for a replica over a group of ranks, broadcasting what it receives).

A replica over a group of ranks (data-parallel copies, a model group's
shards, or both) runs a :class:`DeltaApplier` on every rank over its own
tree: the payloads address the joined tree, each rank writes its share,
and every rank reaches the same verdicts.
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import tempfile
import threading
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.faults import (ChannelFaultSchedule, channel_corrupts,
                                     channel_delay, channel_drops,
                                     channel_stalled)
from repro_torch.core.flatten import (TreeFlattener, tree_from_items,
                                      tree_items, tree_leaves, tree_map)
from repro_torch.core.select import topk_positions
from repro_torch.core.threefry import MASK, mul_u32

# Wire header: version u32 + count u32 + j u64 + checksum u32, padded.
DELTA_HEADER_BYTES = 24
INDEX_LIMIT = 1 << 31            # payload indices are int32


class DeltaVersionError(RuntimeError):
    """A delta's version violates the staleness contract (out of order,
    gapped, or at or below a restored checkpoint's version floor)."""


def check_index_range(j: int) -> None:
    """Raise for a model whose flat indices do not fit the payload's
    int32 index."""
    if j >= INDEX_LIMIT:
        raise ValueError(
            f"J = {j:,} parameters: delta payloads index in int32, so J "
            f"must stay below 2^31 = {INDEX_LIMIT:,}")


# ---------------------------------------------------------------------------
# Checksum and payload
# ---------------------------------------------------------------------------

def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of 4-byte elements, as int64 values."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK


def payload_checksum(values: torch.Tensor, indices: torch.Tensor, version,
                     count, j) -> torch.Tensor:
    """Position-weighted uint32 checksum over the payload's bit patterns,
    a 0-d int64 tensor on the values' device (no host read):
    sum(vbits * (pos * 2654435761 + 1)) + sum(ibits * (pos * 40503 +
    2654435769)) + 97 version + 89 count + 83 j, mod 2^32. Products are
    exact in 16-bit halves and sums stay below 2^63 for k < 2^31, so the
    result is the reference's bit for bit on any device."""
    vb = _u32_bits(values.to(torch.float32))
    ib = _u32_bits(indices.to(device=vb.device, dtype=torch.int32))
    pos = torch.arange(vb.shape[0], dtype=torch.int64, device=vb.device)
    h = mul_u32(vb, (pos * 2654435761 + 1) & MASK).sum()
    h = h + mul_u32(ib, (pos * 40503 + 2654435769) & MASK).sum()
    header = ((int(version) & MASK) * 97 + (int(count) & MASK) * 89
              + (int(j) & MASK) * 83)
    return (h + header) & MASK


def payload_health(values: torch.Tensor, indices: torch.Tensor, checksum,
                   version, count, j):
    """The intake guard without a host read: 0-d bools ``(ok, corrupt,
    nonfinite)`` on the values' device."""
    values = values.to(torch.float32)
    indices = indices.to(device=values.device, dtype=torch.int32)
    finite = torch.isfinite(values).all()
    pos = torch.arange(indices.shape[0], device=values.device)
    live = pos < int(count)
    in_range = (~live | ((indices >= 0) & (indices < j))).all()
    checksum = torch.as_tensor(checksum, device=values.device) \
        .to(torch.int64) & MASK
    want = payload_checksum(values, indices, version, count, j)
    corrupt = (want != checksum) | ~in_range
    return ~corrupt & finite, corrupt, ~finite


@dataclasses.dataclass(frozen=True)
class DeltaPayload:
    """One wire unit: ``count`` live (value, index) pairs at ``version``.
    ``values`` are fp32 absolute new values, ``indices`` int32 positions
    in the TreeFlattener order of a ``j``-element model (tensors on any
    device); ``checksum`` is stamped by the publisher."""
    version: int
    values: torch.Tensor       # (k,) float32
    indices: torch.Tensor      # (k,) int32
    count: int
    j: int
    checksum: int

    @classmethod
    def stamp(cls, version, values, indices, count, j) -> "DeltaPayload":
        values = torch.as_tensor(values).to(torch.float32)
        indices = torch.as_tensor(indices).to(torch.int32)
        csum = int(payload_checksum(values, indices, version, count, j))
        return cls(int(version), values, indices, int(count), int(j), csum)

    def verify(self) -> str:
        """'ok' | 'corrupt' | 'nonfinite'. Checksum, shape and index-range
        failures are 'corrupt' (the transport mangled it); a checksum-valid
        payload with non-finite values is 'nonfinite' (the publisher
        shipped poison). Both are dropped and never reach live params."""
        v, i = self.values, self.indices
        if v.ndim != 1 or v.shape != i.shape:
            return "corrupt"
        want = int(payload_checksum(v, i, self.version, self.count, self.j))
        if want != (self.checksum & MASK):
            return "corrupt"
        live = i[:min(max(self.count, 0), i.shape[0])]
        if live.numel() and (int(live.min()) < 0
                             or int(live.max()) >= self.j):
            return "corrupt"
        if not bool(torch.isfinite(v).all()):
            return "nonfinite"
        return "ok"

    def wire_bytes(self) -> int:
        return delta_wire_bytes(int(self.values.shape[0]))

    def to(self, device) -> "DeltaPayload":
        """The payload with its values and indices on ``device``."""
        return dataclasses.replace(self, values=self.values.to(device),
                                   indices=self.indices.to(device))

    def to_dict(self) -> dict:
        """The spool's npz fields, the reference's keys and dtypes."""
        return {"version": np.int64(self.version),
                "values": self.values.detach().cpu().numpy()
                .astype(np.float32),
                "indices": self.indices.detach().cpu().numpy()
                .astype(np.int32),
                "count": np.int64(self.count), "j": np.int64(self.j),
                "checksum": np.uint32(self.checksum & MASK)}

    @classmethod
    def from_dict(cls, d) -> "DeltaPayload":
        return cls(int(d["version"]),
                   torch.from_numpy(np.asarray(d["values"], np.float32)),
                   torch.from_numpy(np.asarray(d["indices"], np.int32)),
                   int(d["count"]), int(d["j"]), int(d["checksum"]))


# ---------------------------------------------------------------------------
# The shared O(k) scatter: the publisher's mirror and the replica run this
# ---------------------------------------------------------------------------

def _leaf_bounds(flattener: TreeFlattener, idx: torch.Tensor) -> list:
    """For ascending flat indices, where each leaf's run starts: leaf i
    holds ``idx[b[i]:b[i + 1]]``, negative indices fall before b[0] and
    those past J after b[-1]. One host read."""
    edges = torch.tensor(flattener.offsets + [flattener.total],
                         dtype=torch.int64, device=idx.device)
    return torch.searchsorted(idx, edges).tolist()


def scatter_set_tree(flattener: TreeFlattener, tree: dict, values, indices,
                     count=None) -> dict:
    """A new tree with ``values`` set at the flat ``indices`` (the first
    ``count`` pairs; all without it); indices outside [0, J) write
    nothing. Values are cast to each leaf's dtype at the leaf. Functional:
    a leaf with a pair in it is cloned before the write, the others are
    the input's tensors, so a tree pinned by a reader never changes. Live
    indices must be distinct."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    idx = torch.as_tensor(indices).to(device=dev, dtype=torch.int64)
    vals = torch.as_tensor(values).to(device=dev, dtype=torch.float32)
    if count is not None:
        n = min(max(int(count), 0), idx.shape[0])
        idx, vals = idx[:n], vals[:n]
    idx, order = torch.sort(idx, stable=True)
    vals = vals[order]
    bounds = _leaf_bounds(flattener, idx)
    out = []
    for (path, leaf), off, lo, hi in zip(tree_items(tree), flattener.offsets,
                                         bounds, bounds[1:]):
        if hi > lo:
            leaf = leaf.detach().clone()
            leaf.view(-1).index_put_((idx[lo:hi] - off,),
                                     vals[lo:hi].to(leaf.dtype))
        out.append((path, leaf))
    return tree_from_items(out)


# ---------------------------------------------------------------------------
# Publisher (trainer side)
# ---------------------------------------------------------------------------

class DeltaPublisher:
    """Stamps the trainer's post-step movement into versioned payloads.

    ``published`` mirrors what a caught-up replica holds: at version 0 a
    deep copy of the constructor's params (the trainer's params may be
    views into its optimizer's master; the mirror owns its storage), the
    base to ship to replicas as a snapshot. :meth:`publish` selects the
    top-k of ``|flatten(params) - flatten(published)|`` in ``lax.top_k``
    order, ships the absolute new values there in index order, and folds
    them into the mirror."""

    def __init__(self, params: dict, k: int, *, record_history: bool = False):
        self.flattener = TreeFlattener(params)
        self.j = int(self.flattener.total)
        check_index_range(self.j)
        self.k = int(max(1, min(int(k), self.j)))
        self.version = 0
        self.published = tree_map(lambda l: l.detach().clone(), params)
        self.record_history = bool(record_history)
        self._history = {0: self._host_copy()} if record_history else {}

    def _host_copy(self) -> dict:
        return tree_map(lambda l: l.detach().cpu().clone(), self.published)

    def topk(self, params: dict) -> torch.Tensor:
        """The sorted int64 flat indices of the k largest ``|params -
        published|``, without a J-vector of either tree: the difference is
        written leaf by leaf into one fp32 J-vector."""
        pub = tree_leaves(self.published)
        diff = torch.empty(self.j, dtype=torch.float32, device=pub[0].device)
        with torch.no_grad():
            for leaf, old, off, size in zip(tree_leaves(params), pub,
                                            self.flattener.offsets,
                                            self.flattener.sizes):
                torch.sub(leaf.detach().reshape(-1).float(),
                          old.reshape(-1).float(),
                          out=diff[off:off + size]).abs_()
            return torch.sort(topk_positions(diff, self.k)).values

    def gather(self, params: dict, idx: torch.Tensor) -> torch.Tensor:
        """fp32 values of ``params`` at the sorted flat indices ``idx``."""
        bounds = _leaf_bounds(self.flattener, idx)
        parts = [leaf.detach().reshape(-1)[idx[lo:hi] - off].float()
                 for leaf, off, lo, hi in zip(tree_leaves(params),
                                              self.flattener.offsets,
                                              bounds, bounds[1:])
                 if hi > lo]
        return torch.cat(parts)

    def publish(self, params: dict) -> DeltaPayload:
        """One post-step publish: the stamped payload of version
        ``self.version + 1``; the mirror advances."""
        idx = self.topk(params)
        vals = self.gather(params, idx)
        idx = idx.to(torch.int32)
        self.published = scatter_set_tree(self.flattener, self.published,
                                          vals, idx)
        self.version += 1
        if self.record_history:
            self._history[self.version] = self._host_copy()
        return DeltaPayload.stamp(self.version, vals, idx, self.k, self.j)

    def params_at(self, version: int) -> dict:
        """The mirror as of ``version`` (CPU copies; needs
        ``record_history=True``): the oracle side of the contract."""
        if not self.record_history:
            raise ValueError("DeltaPublisher(record_history=True) required")
        return self._history[int(version)]

    def write_snapshot(self, snap_dir: str) -> str:
        """The mirror as a resync snapshot at the current version."""
        return write_snapshot(snap_dir, self.published, self.version)


# ---------------------------------------------------------------------------
# Resync snapshots (checkpoint/io.py)
# ---------------------------------------------------------------------------

def write_snapshot(snap_dir: str, params: dict, version: int) -> str:
    """``params`` as a params-only checkpoint at step ``version`` with
    ``param_version`` stamped in its manifest."""
    from repro_torch.checkpoint.io import save_checkpoint
    return save_checkpoint(snap_dir, int(version), params, {}, {},
                           param_version=int(version))


def latest_snapshot(snap_dir: str, groups=()):
    """The latest snapshot step under ``snap_dir`` (None: none); over a
    grid of ranks (:func:`grid_groups`) the one grid rank 0 finds, on
    every rank."""
    from repro_torch.checkpoint.io import latest_step
    return _group_broadcast(latest_step(snap_dir), groups)


def read_snapshot(snap_dir: str, params_template: dict,
                  step: Optional[int] = None, device=None, model_group=None):
    """A resync snapshot -> ``(params, param_version)``, on ``device``
    (default: the template leaves'); ``step`` defaults to the latest.
    With a ``model_group`` the snapshot is the joined tree and the
    template this rank's shard: each leaf is read on the host, cut to
    the rank's share (``convert.split_leaf``) and moved to the device
    before the next is read, so no card holds the joined tree."""
    from repro_torch.checkpoint.io import (latest_step, load_leaves,
                                           read_manifest, restore_checkpoint,
                                           to_tensor)
    if step is None:
        step = latest_step(snap_dir)
        if step is None:
            raise FileNotFoundError(f"no snapshot in {snap_dir!r}")
    if model_group is None:
        params, _, _ = restore_checkpoint(snap_dir, step, params_template,
                                          {}, {}, device=device)
    else:
        from repro_torch.convert import split_leaf
        from repro_torch.models.parallel import world
        tp, rank = world(model_group)
        fname = os.path.join(snap_dir, f"step_{step:08d}.params.npz")
        items = []
        for path, leaf, tmpl in load_leaves(fname, params_template):
            part = split_leaf(path, leaf, tp, rank)
            if tuple(part.shape) != tuple(tmpl.shape):
                raise ValueError(f"snapshot leaf {path} of {leaf.shape} "
                                 f"gives a share of {tuple(part.shape)} at "
                                 f"tp={tp}, the replica holds "
                                 f"{tuple(tmpl.shape)}")
            items.append((path, to_tensor(part, tmpl, device)))
        params = tree_from_items(items)
    version = read_manifest(snap_dir, step).get("param_version")
    return params, int(step if version is None else version)


# ---------------------------------------------------------------------------
# Applier (replica side)
# ---------------------------------------------------------------------------

class _ShardMap:
    """How flat indices of one leaf of the joined (global, padded) tree
    land in this model rank's shard of it: the split dimension's extent
    in the joined leaf and in the shard, the stride of one step along it,
    and the entries of the padded layout that are not padding
    (``models.specs.real_entries``)."""

    def __init__(self, path, local_shape, tp: int, rank: int, cfg):
        from repro_torch.models.specs import leaf_dim, real_entries
        dim = leaf_dim(path, len(local_shape))
        shape = list(local_shape)
        if dim is not None:
            shape[dim] *= tp
        self.shape = tuple(shape)
        self.numel = int(np.prod(local_shape, dtype=np.int64))
        self.rank = rank
        self.split = None if dim is None else (
            int(np.prod(shape[dim + 1:], dtype=np.int64)), shape[dim],
            local_shape[dim])
        real = None if cfg is None else real_entries(path, self.shape, cfg,
                                                     tp)
        self.real = None if real is None else (
            int(np.prod(shape[real[0] + 1:], dtype=np.int64)),
            shape[real[0]], real[1])

    def local(self, lin: torch.Tensor) -> torch.Tensor:
        """The shard's flat positions of the joined leaf's flat positions
        ``lin`` (int64), or ``numel`` (one past the shard) where the entry
        is another rank's or padding."""
        keep = torch.ones_like(lin, dtype=torch.bool)
        if self.real is not None:
            inner, size, real = self.real
            keep &= real.to(lin.device)[(lin // inner) % size]
        if self.split is None:
            return torch.where(keep, lin, self.numel)
        inner, size, n = self.split
        coord = (lin // inner) % size
        keep &= coord // n == self.rank
        pos = (lin // (inner * size)) * (n * inner) \
            + (coord - self.rank * n) * inner + lin % inner
        return torch.where(keep, pos, self.numel)


def _scatter_shards(maps: list, flattener: TreeFlattener, tree: dict,
                    values, indices, count) -> dict:
    """:func:`scatter_set_tree` for a model rank's shard of the joined
    tree: the payload's flat joined indices mapped to this rank's
    positions leaf by leaf on the device (:class:`_ShardMap`), the
    entries of other ranks and the padding written into one spare slot
    past the leaf and dropped. A leaf with a pair of the joined leaf in
    it is cloned (with its spare slot), whichever rank owns the pairs, so
    nothing waits on the host but the leaf bounds."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    idx = torch.as_tensor(indices).to(device=dev, dtype=torch.int64)
    vals = torch.as_tensor(values).to(device=dev, dtype=torch.float32)
    n = min(max(int(count), 0), idx.shape[0])
    idx, order = torch.sort(idx[:n], stable=True)
    vals = vals[:n][order]
    bounds = _leaf_bounds(flattener, idx)
    out = []
    for (path, leaf), smap, off, lo, hi in zip(
            tree_items(tree), maps, flattener.offsets, bounds, bounds[1:]):
        if hi > lo:
            buf = torch.empty(smap.numel + 1, dtype=leaf.dtype, device=dev)
            buf[:smap.numel].copy_(leaf.detach().reshape(-1))
            buf.index_put_((smap.local(idx[lo:hi] - off),),
                           vals[lo:hi].to(leaf.dtype))
            leaf = buf[:smap.numel].view(leaf.shape)
        out.append((path, leaf))
    return tree_from_items(out)


def grid_groups(group=None, model_group=None) -> tuple:
    """The process groups of a replica's grid of ranks, the model group
    first, then the data group; () for one rank (neither given)."""
    return tuple(g for g in (model_group, group) if g is not None)


def _group_max(flags: torch.Tensor, groups) -> torch.Tensor:
    """The elementwise maximum of ``flags`` over every rank of the
    groups (:func:`grid_groups`: every rank of the serving grid)."""
    import torch.distributed as dist

    from repro_torch.models.parallel import world
    for g in groups:
        if world(g)[0] > 1:
            dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=g)
    return flags


def _group_broadcast(obj, groups):
    """Rank 0's ``obj`` (of every rank of the grid, :func:`grid_groups`)
    on every rank: over the model group from its rank 0, then over the
    data group from its rank 0, so the grid's rank 0 reaches every
    rank."""
    import torch.distributed as dist

    from repro_torch.models.parallel import world
    for g in groups:
        if world(g)[0] > 1:
            box = [obj]
            dist.broadcast_object_list(box, group_src=0, group=g)
            obj = box[0]
    return obj


class DeltaApplier:
    """Applies versioned deltas to live serving params between decode
    steps, under the staleness contract.

    - :meth:`offer` is channel-tolerant: corrupt, non-finite and stale
      payloads are dropped on counters; a gap sets ``needs_resync`` and
      every later offer is refused (``resync_pending``) until
      :meth:`resync_from` restores a newer snapshot. Nothing raises.
    - :meth:`apply` is strict: it raises :class:`DeltaVersionError` on any
      violation, including a version at or below the restored floor.

    ``params`` is held, not copied: the caller hands over a tree that
    nothing else writes (applies never write it in place). A payload is
    moved to the params' device at intake, so its checksum is verified
    where it is applied (on the card, not on the host).

    Over a group of ranks (a replica served over a data ``group`` and a
    ``model_group``, as ``launch.mesh.make_group`` cuts them) each rank
    holds its own tree: a copy of the whole under a data-parallel batch,
    its shard (``convert.split_params``' padded layout) under tensor
    parallelism. ``j`` and the payloads' indices are the joined tree's,
    which a tensor-parallel trainer publishes; each rank maps them to
    its shard on the device, a leaf at a time, writes a replicated leaf
    whole, and never writes another rank's entries or the padding of
    ``cfg``'s heads, vocabulary and experts (``models.specs.
    real_entries``; without ``cfg`` nothing is taken for padding). The
    intake verdict is every rank's worst (a MAX all-reduce of the
    checks over the grid), so every rank reaches the same verdict, the
    same version and the same counters for every payload, and a snapshot
    to resync from is the one grid rank 0 finds. Every rank must offer
    the same payloads in the same order (``GroupChannel``)."""

    COUNTERS = ("received", "applied", "dropped_corrupt",
                "dropped_nonfinite", "dropped_stale", "gaps_detected",
                "resyncs")

    def __init__(self, params: dict, *, version: int = 0,
                 version_floor: Optional[int] = None, group=None,
                 model_group=None, cfg=None):
        from repro_torch.models.parallel import world
        self.groups = grid_groups(group, model_group)
        self.model_group = model_group
        tp, rank = (1, 0) if model_group is None else world(model_group)
        items = tree_items(params)
        self.maps = None if tp == 1 else [
            _ShardMap(path, tuple(leaf.shape), tp, rank, cfg)
            for path, leaf in items]
        self.flattener = TreeFlattener(params if self.maps is None else
                                       tree_from_items(
            (path, torch.empty(m.shape, device="meta"))
            for (path, _), m in zip(items, self.maps)))
        self.j = int(self.flattener.total)
        check_index_range(self.j)
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.version = int(version)
        self.floor = int(version if version_floor is None else version_floor)
        self.needs_resync = False
        self.counters = {c: 0 for c in self.COUNTERS}

    def offer(self, payload: DeltaPayload) -> str:
        """Channel-tolerant intake; the verdict: 'applied' | 'corrupt' |
        'nonfinite' | 'stale' | 'gap' | 'resync_pending'."""
        self.counters["received"] += 1
        payload = payload.to(self.device)
        verdict = self._verdict(payload)
        if verdict == "corrupt" or (verdict == "ok" and payload.j != self.j):
            self.counters["dropped_corrupt"] += 1
            return "corrupt"
        if verdict == "nonfinite":
            self.counters["dropped_nonfinite"] += 1
            return "nonfinite"
        if self.needs_resync:
            return "resync_pending"
        if payload.version <= self.version:
            self.counters["dropped_stale"] += 1
            return "stale"
        if payload.version != self.version + 1:
            self.counters["gaps_detected"] += 1
            self.needs_resync = True
            return "gap"
        self._apply_verified(payload)
        return "applied"

    def apply(self, payload: DeltaPayload) -> None:
        """Strict intake: raises on any contract violation."""
        self.counters["received"] += 1
        payload = payload.to(self.device)
        verdict = self._verdict(payload)
        if verdict != "ok" or payload.j != self.j:
            raise DeltaVersionError(
                f"refusing {verdict} delta v{payload.version} "
                f"(j={payload.j}, want {self.j})")
        if self.needs_resync:
            raise DeltaVersionError(
                f"mid-resync at v{self.version}: refusing to advance")
        if payload.version <= self.floor:
            raise DeltaVersionError(
                f"delta v{payload.version} is at/below the restored "
                f"checkpoint floor v{self.floor}: it predates the restored "
                "state and must never be applied")
        if payload.version != self.version + 1:
            raise DeltaVersionError(
                f"delta v{payload.version} on top of v{self.version}: "
                "versions must be contiguous")
        self._apply_verified(payload)

    def _verdict(self, payload: DeltaPayload) -> str:
        """``payload.verify()``, the grid's worst over a group."""
        verdict = payload.verify()
        if not self.groups:
            return verdict
        flags = torch.tensor([verdict == "corrupt", verdict == "nonfinite"],
                             dtype=torch.int32, device=self.device)
        corrupt, nonfinite = _group_max(flags, self.groups).tolist()
        return "corrupt" if corrupt else "nonfinite" if nonfinite else "ok"

    def _apply_verified(self, payload: DeltaPayload) -> None:
        if self.maps is None:
            self.params = scatter_set_tree(self.flattener, self.params,
                                           payload.values, payload.indices,
                                           payload.count)
        else:
            self.params = _scatter_shards(self.maps, self.flattener,
                                          self.params, payload.values,
                                          payload.indices, payload.count)
        self.version = payload.version
        self.counters["applied"] += 1

    def acquire(self):
        """Pin ``(params, version)`` for a decode stream: applies never
        write a tree in place, so the pinned tensors stay unchanged for
        the stream's whole life."""
        return self.params, self.version

    def can_resync(self, snap_dir: str) -> bool:
        """Is a snapshot strictly newer than the held version there?"""
        step = latest_snapshot(snap_dir, self.groups)
        return step is not None and step > self.version

    def resync_from(self, snap_dir: str, step: Optional[int] = None) -> int:
        """Restore the snapshot (the latest by default) in the held
        leaves' dtypes and devices, raise the floor to its version and
        re-arm intake. Under a model group each rank keeps its share of
        the joined snapshot, read and cut a leaf at a time. Raises
        :class:`DeltaVersionError` if it would move the replica
        backwards."""
        if step is None:
            step = latest_snapshot(snap_dir, self.groups)
        params, version = read_snapshot(
            snap_dir, self.params, step,
            model_group=self.model_group if self.maps is not None else None)
        if version < self.version:
            raise DeltaVersionError(
                f"snapshot v{version} is older than held v{self.version}: "
                "resync must never move a replica backwards")
        self.params = tree_from_items(
            (path, new.to(old.dtype)) for (path, old), (_, new)
            in zip(tree_items(self.params), tree_items(params)))
        self.version = version
        self.floor = version
        self.needs_resync = False
        self.counters["resyncs"] += 1
        return version

    def metrics(self) -> dict:
        """Version and health counters."""
        return {"param_version": self.version,
                "needs_resync": self.needs_resync, **self.counters}


def drain(channel, applier: DeltaApplier) -> list:
    """Offer every payload the channel has ready; returns the verdicts."""
    return [applier.offer(p) for p in channel.recv()]


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class MemoryChannel:
    """In-process FIFO."""

    def __init__(self):
        self._q = deque()

    def send(self, payload: DeltaPayload) -> None:
        self._q.append(payload)

    def recv(self) -> list:
        out = []
        while True:
            try:
                out.append(self._q.popleft())
            except IndexError:
                return out


class SpoolChannel:
    """One file a payload in a spool directory, named by a monotonic send
    sequence number and the version (``delta_%08d_%08d.npz``), written
    atomically (temporary file, then rename). The receiver sees the
    channel's delivery order even when a fault wrapper reordered
    versions, and remembers the last sequence number it read. Sender and
    receiver are separate instances."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        seqs = [self._parse(f)[0] for f in os.listdir(root)
                if f.startswith("delta_") and f.endswith(".npz")]
        self._seq = max(seqs) + 1 if seqs else 0
        self._read_seq = -1

    @staticmethod
    def _parse(fname: str):
        stem = fname[:-len(".npz")].split("_")
        return int(stem[1]), int(stem[2])

    def send(self, payload: DeltaPayload) -> None:
        with self._lock:
            seq = self._seq
            self._seq += 1
        fname = f"delta_{seq:08d}_{payload.version:08d}.npz"
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload.to_dict())
        os.replace(tmp, os.path.join(self.root, fname))

    def recv(self) -> list:
        ready = sorted(
            (self._parse(f), f) for f in os.listdir(self.root)
            if f.startswith("delta_") and f.endswith(".npz")
            and self._parse(f)[0] > self._read_seq)
        out = []
        for (seq, _), fname in ready:
            with np.load(os.path.join(self.root, fname)) as d:
                out.append(DeltaPayload.from_dict(d))
            self._read_seq = seq
        return out


class FaultyChannel:
    """Injects a seeded ``core.faults`` channel schedule around a transport,
    on the send side or the receive side (the per-version decisions are
    the same either way). ``loss`` drops the payload; ``corrupt`` flips a
    value bit after the checksum was stamped; ``reorder`` delays each
    version by a seeded amount and releases by (due, version); ``stall``
    holds the window and flushes it in order afterwards. Call
    :meth:`flush` when the stream ends."""

    def __init__(self, inner, sched: Optional[ChannelFaultSchedule]):
        self.inner = inner
        self.sched = sched
        self._pending = []      # reorder: heap of (due, version, seq, payload)
        self._stalled = []      # stall: arrival-order buffer
        self._seq = 0
        self._send_mode = False
        self.counters = {"sent": 0, "dropped": 0, "corrupted": 0,
                         "delayed": 0, "stalled": 0}

    def _process(self, payload: DeltaPayload) -> list:
        sched, v = self.sched, payload.version
        if sched is None:
            return [payload]
        if sched.kind == "loss":
            if bool(channel_drops(sched, v)):
                self.counters["dropped"] += 1
                return []
            return [payload]
        if sched.kind == "corrupt":
            if bool(channel_corrupts(sched, v)):
                self.counters["corrupted"] += 1
                return [_flip_bit(payload)]
            return [payload]
        if sched.kind == "stall":
            if not bool(channel_stalled(sched, v)):
                out, self._stalled = self._stalled, []
                out.append(payload)
                return out
            self._stalled.append(payload)
            self.counters["stalled"] += 1
            return []
        delay = int(channel_delay(sched, v))
        if delay:
            self.counters["delayed"] += 1
        # the sequence number breaks (due, version) ties without
        # comparing payloads
        heapq.heappush(self._pending, (v + delay, v, self._seq, payload))
        self._seq += 1
        out = []
        while self._pending and self._pending[0][0] <= v:
            out.append(heapq.heappop(self._pending)[3])
        return out

    def send(self, payload: DeltaPayload) -> None:
        self._send_mode = True
        for p in self._process(payload):
            self.counters["sent"] += 1
            self.inner.send(p)

    def recv(self) -> list:
        inbound = self.inner.recv()
        if self._send_mode:
            # faults were injected on the send path already
            return inbound
        out = []
        for p in inbound:
            out.extend(self._process(p))
        return out

    def flush(self) -> list:
        """Release everything still held (end of stream): forwarded to the
        inner transport in send mode, returned either way."""
        out, self._stalled = self._stalled, []
        while self._pending:
            out.append(heapq.heappop(self._pending)[3])
        if self._send_mode:
            for p in out:
                self.counters["sent"] += 1
                self.inner.send(p)
        return out


class GroupChannel:
    """The one reader of a replica served over a group of ranks: grid
    rank 0 receives from ``inner`` (its receive-side faults applied
    there, once) and broadcasts the payloads, in order, to every rank of
    the grid (the ``model_group``, then the data ``group``, as
    :class:`DeltaApplier` reads them) before any rank offers one, on
    ``device``; the other ranks pass no ``inner``. So every rank offers
    the same payloads, even when the spool gains a file between two
    ranks' reads. :meth:`recv` and :meth:`flush` are collectives: every
    rank calls them at the same points."""

    def __init__(self, inner, group=None, model_group=None, device=None):
        self.inner = inner
        self.groups = grid_groups(group, model_group)
        self.device = device

    def _share(self, payloads) -> list:
        import torch.distributed as dist

        from repro_torch.models.parallel import world
        heads = None if payloads is None else [
            (p.version, p.count, p.j, p.checksum, tuple(p.values.shape),
             tuple(p.indices.shape)) for p in payloads]
        heads = _group_broadcast(heads, self.groups)
        out = []
        for i, (version, count, j, checksum, vshape, ishape) in \
                enumerate(heads):
            if payloads is None:
                vals = torch.empty(vshape, dtype=torch.float32,
                                   device=self.device)
                idx = torch.empty(ishape, dtype=torch.int32,
                                  device=self.device)
            else:
                vals = payloads[i].values.to(self.device, torch.float32)
                idx = payloads[i].indices.to(self.device, torch.int32)
            for g in self.groups:
                if world(g)[0] > 1:
                    dist.broadcast(vals, group_src=0, group=g)
                    dist.broadcast(idx, group_src=0, group=g)
            out.append(DeltaPayload(version, vals, idx, count, j, checksum))
        return out

    def recv(self) -> list:
        return self._share(None if self.inner is None else self.inner.recv())

    def flush(self) -> list:
        """Release what grid rank 0's channel still holds (a
        FaultyChannel's window), to every rank."""
        held = None
        if self.inner is not None:
            held = self.inner.flush() if hasattr(self.inner, "flush") else []
        return self._share(held)


def _flip_bit(payload: DeltaPayload) -> DeltaPayload:
    """In-flight single-bit corruption of the middle value, the checksum
    left stale, so the intake guard must catch it."""
    vals = payload.values.clone()
    bits = vals.view(torch.int32)
    bits[bits.numel() // 2] ^= 1 << 20
    return dataclasses.replace(payload, values=vals)


# ---------------------------------------------------------------------------
# Wire costs
# ---------------------------------------------------------------------------

def delta_wire_bytes(k: int, value_bytes: int = 4,
                     index_bytes: int = 4) -> int:
    """Wire size of one delta: k (value, index) pairs and the header."""
    return int(k) * (value_bytes + index_bytes) + DELTA_HEADER_BYTES


def resync_bytes(j: int, value_bytes: int = 4) -> int:
    """Wire size of one full-snapshot resync: the whole flat model."""
    return int(j) * value_bytes + DELTA_HEADER_BYTES


def resync_equiv_deltas(j: int, k: int, value_bytes: int = 4,
                        index_bytes: int = 4) -> float:
    """How many deltas one resync costs: a channel losing more than about
    one version in this many spends its savings on snapshots."""
    return resync_bytes(j, value_bytes) / max(
        1, delta_wire_bytes(k, value_bytes, index_bytes))
