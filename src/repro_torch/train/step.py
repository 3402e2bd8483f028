"""Data-parallel training step with sparse gradient sync and a ZeRO-1
optimizer, over a data group and, under tensor parallelism, a model group
(the port of ``repro.train.step``).

Per step:

1. loss and gradient of the model (autograd over the parameter tree),
   with an MoE model's aux terms, which the metrics carry (``lb_loss``,
   ``z_loss``, ``drop_frac``, each summed over the MoE layers);
2. flatten the gradient to the per-rank J-vector (TreeFlattener order);
3. GradientSync: REGTOP-k/TOP-k/DGC/thresholdk/randk compression, on
   the fused pipeline (the two sweep kernels, per bucket with
   ``num_buckets``) or the reference pipeline (the dense score and apply
   kernels, a selector), then the all-gather of the packed (value,
   index) pairs, in ``num_buckets`` chunks on the ``wire_dtype`` wire,
   and a local scatter-add combine (sparse comm) or the all-reduce of
   the dense ghat (simulate comm), ``observe_aggregate``; randk draws
   with the run's seed key folded with the rank, as the reference;
   or, for kind="sketchtopk", the CountSketch encode, the sketch
   all-reduce, the shared-mask decode and the values-only all-gather.
   With ``RunConfig.fault_schedule`` set, the rank's participation bit
   for the step is evaluated on the device from the sparsifier state's
   step counter (``core.faults.participates``, parsed once at build
   time), and the metrics gain ``n_active`` and ``dropped_nonfinite``.
   With ``allocation`` proportional or adaptive the budget splits over
   layer-aligned segments (``core.allocate.layer_segments`` over the
   leaf layout); with ``overlap="backward"`` steps 1-3 interleave: each
   segment (the same cut) is fed to the sync as soon as the backward
   pass has produced its leaves' gradients, its sweeps running on a side
   CUDA stream behind the rest of the backward pass (``_streamed``).
   The step hands the old sparsifier state to the sync (donates it), so
   the reference pipeline's dense J-vectors are freed as soon as the
   compressor has read them: the old TrainState's ``ef`` is consumed;
4. ZeRO-1: this rank updates its 1/DP slice of the optimizer state
   (master, and m, v as the kind keeps them; with ``grad_clip`` the
   step hands the optimizer the global norm of g_agg) and the master is
   all-gathered back; the next step's parameters are views into that
   gathered vector (no extra copy).

Without a process group the world is one rank and the same code runs.

Under tensor parallelism (``model_group``; ranks numbered as
``launch.mesh.make_group`` numbers them) each rank holds its share of
the parameters (``models.specs``) and trains with the residual stream
split by sequence (the reference's ``build_parallel`` default): the loss
is the rank's disjoint share (``transformer.chunked_xent``), the
gradients of the replicated leaves (``specs.replicated_mask``: norms,
the MoE router, MLA's ``dkv`` and ``kv_norm``, the mLSTM's ``up``,
``wq``, ``wk`` and ``wif``) are summed over the model group in rank order before flattening, and the flat
J-vector, the compressor, its state and the ZeRO-1 slices are the rank's
own (J_local), synced over the data group only. With ``grad_clip`` the
global norm weighs a replicated leaf by 1/tp and sums over the model
group. The logged loss is the model group's sum of the shares, averaged
over the data group; every other metric is averaged over both groups.
Streaming (``overlap="backward"``) sums a replicated leaf's gradient
over the model group in its hook. ``attn_dist="ring"`` (the reference's
``build_parallel(mesh, attn_dist="ring")``) trains with ring attention
over the model group (``models.attention.ring_fwd``): every rank all the
heads of its own attention weights, drawn per model rank.
The module also holds the run's checkpoints (:func:`save_train_state`,
:func:`restore_train_state`, in the reference's global layout: under
tensor parallelism the parameters joined over the model group, the
states as ``(DP, TP, ...)``, gathered and written a leaf at a time in
rank 0's host memory) and the delta broadcast's publisher for a run
(:func:`delta_publisher_for_run`, on the joined tree in host memory:
:func:`joined_params`).
The model is ``resolve_model_cfg(run)``: ``RunConfig.attn_override=
"sliding"`` trains a dense model's sliding-window variant.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.backend import configure_numerics, resolve_device
from repro_torch.configs.base import RunConfig, resolve_model_cfg
from repro_torch.core import faults, sparsify, threefry
from repro_torch.core.aggregate import GradientSync, wire_span
from repro_torch.core.flatten import (TreeFlattener, tree_items, tree_leaves,
                                      tree_map)
from repro_torch.core.numerics import norm_f32
from repro_torch.models import init_params, loss_and_aux
from repro_torch.models.parallel import (Parallel, all_reduce_mean,
                                         all_reduce_sum, data_index,
                                         pmean_model, psum_model, world)
from repro_torch.models.specs import replicated_mask
from repro_torch.models.transformer import (AUX_KEYS, global_loss,
                                            init_rank_params)
from repro_torch.optim import apply_updates, init_opt_state, opt_shard_len


# the step's metrics, each the mean over the data-parallel ranks (the
# reference's ``mkeys``); n_active and dropped_nonfinite follow under a
# fault schedule
METRICS = ("loss", "gnorm_local", "agg_nonzero") + AUX_KEYS


@dataclass
class TrainState:
    params: dict          # parameter tree (fp32)
    opt: dict             # this rank's ZeRO-1 optimizer slice
    ef: dict              # sparsifier state


def _as_leaves(tree: dict) -> dict:
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _padded_slice(vec: torch.Tensor, rank: int, shard: int, n: int):
    if n == 1:
        return vec
    return F.pad(vec, (0, n * shard - vec.numel()))[
        rank * shard:(rank + 1) * shard]


def train_parallel(group=None, model_group=None,
                   attn_dist: str = "sp") -> Parallel:
    """The train step's ``Parallel``: the residual stream split by
    sequence over the model group, as the reference's ``build_parallel``
    defaults, and its ``attn_dist`` ("sp": attention by heads; "ring")."""
    return Parallel(group=group, model_group=model_group, seq_parallel=True,
                    attn_dist=attn_dist)


def init_train_state(run: RunConfig, device=None, group=None,
                     params: dict = None, model_group=None,
                     attn_dist: str = "sp") -> TrainState:
    """Fresh state: parameters drawn from ``run.seed`` (under tensor
    parallelism this rank's share: ``transformer.init_rank_params``), or
    the given tree (this rank's, e.g. cut from the reference's by
    ``convert.split_params``), this rank's optimizer slice, and zero
    sparsifier state."""
    dev = resolve_device(device)
    if params is None:
        params = init_rank_params(resolve_model_cfg(run), run.seed, dev,
                                  train_parallel(group, model_group,
                                                 attn_dist))
    params = tree_map(lambda t: t.to(dev, torch.float32), params)
    flat = TreeFlattener(params)
    n, rank = world(group)[0], data_index(group)
    shard = opt_shard_len(flat.total, n)
    master = _padded_slice(flat.flatten(params), rank, shard, n).clone() \
        if n > 1 else flat.flatten(params)
    opt = init_opt_state(run.optimizer, master)
    ef = sparsify.init_state(run.sparsifier, flat.total, dev)
    return TrainState(_as_leaves(params), opt, ef)


class TrainStep:
    """``step(state, batch) -> (state, metrics)``. Metrics are device
    tensors (reading them is the caller's choice of host sync). The old
    state's sparsifier state is consumed (``state.ef`` becomes None).
    ``gsync.fallback_reasons`` counts the steps whose trim took the exact
    fallback, by reason. ``group`` is the data group, ``model_group`` the
    model group (None: tensor-parallel degree 1), ``attn_dist`` the
    attention's distribution over it ("sp" or "ring"). Each call starts a
    step of ``repro_torch.trace`` (its id, and whether it is traced): a
    traced step adds ``model/forward`` around the loss and
    ``model/backward`` on the thread that runs the backward pass
    (:class:`_BackwardSpan`), both inside ``train/loss_grad``."""

    def __init__(self, run: RunConfig, device=None, group=None,
                 model_group=None, attn_dist: str = "sp"):
        resolve_device(device)
        configure_numerics()
        self.run = run
        self.group = group
        self.pal = train_parallel(group, model_group, attn_dist)
        sp = run.sparsifier
        # the leaf layout, from parameters drawn on the meta device: the
        # allocation's segments are layer-aligned (leaves grouped, never
        # cut), and the stream's are the same cut (or the same rule when
        # the allocation is global)
        tmpl = init_params(resolve_model_cfg(run), torch.Generator(),
                           torch.device("meta"), self.pal)
        flat = TreeFlattener(tmpl)
        # the leaves replicated over the model group (none at tp 1)
        self.replicated = [self.pal.tp_on and rep for _, rep in
                           tree_items(replicated_mask(tmpl))]
        cut = None
        if sp.allocation != "global" or sp.overlap == "backward":
            from repro_torch.core import allocate
            cut = allocate.layer_segments(
                flat.layer_bounds(),
                allocate.resolve_num_segments(sp, flat.total))
        self.seg_bounds = cut if sp.allocation != "global" else None
        self.stream_bounds = cut if sp.overlap == "backward" else None
        self._side = None               # the stream the segments are fed on
        # num_buckets=0 resolves here, from J_local and the data group
        self.gsync = GradientSync(sp, group, j=flat.total,
                                  seg_bounds=self.seg_bounds,
                                  stream_bounds=self.stream_bounds)
        self.schedule = faults.parse_schedule(run.fault_schedule)

    def __call__(self, state: TrainState, batch: dict):
        trace.begin_step()
        cfg, opt_cfg = resolve_model_cfg(self.run), self.run.optimizer
        n, rank = world(self.group)[0], data_index(self.group)
        flat = TreeFlattener(state.params)
        leaves = tree_leaves(state.params)
        ef, state.ef = state.ef, None
        dev = leaves[0].device
        key = part = stats = None
        if self.run.sparsifier.kind == "randk":
            # the reference's: the run's seed key, folded with the
            # data-parallel rank (the same key every step)
            key = threefry.fold_in(threefry.prng_key(self.run.seed, dev),
                                   rank)
        if self.schedule is not None:
            part = faults.participates(self.schedule, ef["step"], rank)
        if self.stream_bounds is not None:
            loss, aux, g_agg, ef, stats, gnorm_local = self._streamed(
                state, batch, cfg, flat, leaves, ef, key, part)
        else:
            bwd = _BackwardSpan(leaves)
            with trace.span("train/loss_grad"):
                try:
                    with trace.span("model/forward", device=True):
                        loss, aux = loss_and_aux(state.params, batch, cfg,
                                                 self.pal)
                    bwd.watch(loss)
                    grads = torch.autograd.grad(loss, leaves)
                finally:
                    bwd.close()
                grads = [self._replicated_sum(i, grad)
                         for i, grad in enumerate(grads)]
            with trace.span("train/flatten"):
                g = flat.flatten(list(grads))
                del grads
                gnorm_local = norm_f32(g)
            with trace.span("train/sync"):
                if part is None:
                    g_agg, ef = self.gsync(ef, g, donate=True, key=key)
                else:
                    g_agg, ef, stats = self.gsync(ef, g, participate=part,
                                                  donate=True,
                                                  with_stats=True, key=key)
                del g
        with trace.span("train/optimizer"):
            shard = opt_shard_len(flat.total, n)
            opt = state.opt
            if opt_cfg.grad_clip:
                # the global norm of g_agg, a replicated leaf weighed by
                # 1/tp, summed over the model group
                gn2 = g_agg.float() ** 2
                if self.pal.tp_on:
                    gn2 = gn2 * self._dup_weights(flat, gn2.device)
                opt = dict(opt, gnorm=torch.sqrt(psum_model(
                    torch.sum(gn2), self.pal)))
            master, opt = apply_updates(opt_cfg, opt,
                                        _padded_slice(g_agg, rank, shard, n))
            if n > 1:
                mall = torch.empty(n * shard, dtype=master.dtype,
                                   device=master.device)
                with wire_span("sync/allgather_master", master):
                    dist.all_gather_into_tensor(mall, master,
                                                group=self.group)
            else:
                mall = master
            params = _as_leaves(flat.unflatten(mall[:flat.total]))
        # the reference's pmean of every metric: one gather, a sum in rank
        # order, the scale by fp32(1/n); the loss is first the model
        # group's sum of the shares, every other metric the model group's
        # mean; the MoE aux terms are each summed over the MoE layers (0
        # without any)
        rest = pmean_model(torch.stack([
            gnorm_local.float(), (g_agg != 0).float().mean(),
            *(aux[key].detach() for key in AUX_KEYS)]), self.pal)
        means = all_reduce_mean(torch.cat([
            global_loss(loss, self.pal).reshape(1), rest]), self.group)
        metrics = dict(zip(METRICS, means.unbind(0)))
        if stats is not None:
            metrics.update(stats)        # already sums over the ranks
        return TrainState(params, opt, ef), metrics

    def _replicated_sum(self, i: int, grad: torch.Tensor) -> torch.Tensor:
        """Leaf i's gradient, summed over the model group in rank order
        where the leaf is replicated over it."""
        if not self.replicated[i]:
            return grad
        return all_reduce_sum(grad, self.pal.model_group)

    def _dup_weights(self, flat, device) -> torch.Tensor:
        """(J,) weights of the global norm: 1/tp on the replicated leaves'
        elements (each model rank holds a copy), 1 elsewhere."""
        return torch.cat([torch.full((size,), 1.0 / self.pal.tp if rep
                                     else 1.0, device=device)
                          for size, rep in zip(flat.sizes,
                                               self.replicated)])

    def _streamed(self, state, batch, cfg, flat, leaves, ef, key, part):
        """Loss and gradient with the sync's compression streamed behind
        the backward pass (``overlap="backward"``): a hook on each leaf
        copies its gradient into its place in one (J,) buffer; when a
        segment's last leaf has arrived, an event is recorded on the
        producing stream and the segment is fed to the sync on a side
        CUDA stream that waits on it, so its sweeps run while the
        backward pass goes on. ``finish`` waits for the side stream. A
        leaf used twice (tied embeddings) fires its hook once, with the
        summed gradient. Returns (loss, aux, g_agg, ef, stats,
        gnorm_local), gnorm_local the reference's per-segment form (the square root of
        the sum of the segments' sums of squares)."""
        bounds = self.stream_bounds
        # each leaf's segment (an empty leaf carries nothing: no hook)
        seg_of = [None if size == 0 else
                  next(pos for pos, (off, sz) in enumerate(bounds)
                       if off <= o < off + sz)
                  for o, size in zip(flat.offsets, flat.sizes)]
        left = [0] * len(bounds)
        for pos in seg_of:
            if pos is not None:
                left[pos] += 1
        buf = torch.empty(flat.total, dtype=torch.float32,
                          device=leaves[0].device)
        cuda = buf.device.type == "cuda"
        if cuda and self._side is None:
            self._side = torch.cuda.Stream(buf.device)
        side = self._side
        stream = self.gsync.begin(ef, key=key, participate=part)

        def feed(pos: int) -> None:
            off, size = bounds[pos]
            seg = buf[off:off + size]
            if not cuda:
                stream.feed_segment(seg, offset=off)
                return
            ready = torch.cuda.Event()
            ready.record()              # on the producing stream
            side.wait_event(ready)
            with torch.cuda.stream(side):
                stream.feed_segment(seg, offset=off)

        def hook(i: int):
            off, size = flat.offsets[i], flat.sizes[i]

            def arrived(grad):
                grad = self._replicated_sum(i, grad)
                buf[off:off + size].copy_(grad.reshape(-1))
                pos = seg_of[i]
                left[pos] -= 1
                if not left[pos]:
                    feed(pos)
            return arrived

        # hooked first, so that the backward's span ends before the last
        # segment is fed
        bwd = _BackwardSpan(leaves)
        handles = [leaf.register_hook(hook(i))
                   for i, leaf in enumerate(leaves) if seg_of[i] is not None]
        try:
            with trace.span("train/loss_grad"):
                with trace.span("model/forward", device=True):
                    loss, aux = loss_and_aux(state.params, batch, cfg,
                                             self.pal)
                bwd.watch(loss)
                grads = torch.autograd.grad(loss, leaves)
                del grads
        finally:
            bwd.close()
            for h in handles:
                h.remove()
        with trace.span("train/sync"):
            # buf was written on this stream: its norm need not wait for
            # the side stream's sweeps
            gnorm_local = torch.sqrt(sum(
                buf[off:off + size].square().sum() for off, size in bounds))
            if cuda:
                main = torch.cuda.current_stream(buf.device)
                main.wait_stream(side)
                for x in [buf] + stream.side_outputs():
                    x.record_stream(side if x is buf else main)
            if part is None:
                g_agg, ef = stream.finish()
                stats = None
            else:
                g_agg, ef, stats = stream.finish(with_stats=True)
        return loss, aux, g_agg, ef, stats, gnorm_local


class _BackwardSpan:
    """While the step is traced, the ``model/backward`` span on the thread
    that runs the backward pass (autograd's device thread on a card, the
    caller's on the CPU): a hook on the loss, the pass's first node,
    opens it (its parent the caller's open ``train/loss_grad``), and a
    hook on each leaf ends it once the last leaf's gradient is produced
    (a leaf used twice fires once). Registers nothing while tracing is
    off."""

    def __init__(self, leaves: list):
        self.span = None
        self.left = len(leaves)
        self.handles = ([leaf.register_hook(self._arrived)
                         for leaf in leaves] if trace.enabled() else [])

    def watch(self, loss: torch.Tensor) -> None:
        if self.handles:
            self.handles.append(loss.register_hook(self._opened))

    def _opened(self, grad):
        self.span = trace.span("model/backward", device=True)
        self.span.__enter__()

    def _arrived(self, grad):
        self.left -= 1
        if not self.left:
            self._end()

    def _end(self) -> None:
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None

    def close(self) -> None:
        """Remove the hooks, and end a span that a failed pass left
        open."""
        for h in self.handles:
            h.remove()
        self.handles = []
        self._end()


def build_train_step(run: RunConfig, device=None, group=None,
                     model_group=None, attn_dist: str = "sp") -> TrainStep:
    """The train step over the data ``group`` and the ``model_group``;
    ``attn_dist="ring"`` trains with ring attention (the reference's
    ``build_parallel(mesh, attn_dist="ring")``)."""
    return TrainStep(run, device, group, model_group, attn_dist)


def auto_num_buckets_for_run(run: RunConfig, group=None, model_group=None,
                             attn_dist: str = "sp") -> tuple:
    """The train step's own resolution of ``num_buckets=0``: the same
    per-rank J (the flattened rank's parameters, drawn on the meta
    device) and the same data-parallel extent. Out-of-band readers (the
    launcher's log line, the dry run's record) use it, so they never
    disagree with the count the step runs. Returns (num_buckets,
    j_local, dp)."""
    pal = train_parallel(group, model_group, attn_dist)
    tmpl = init_params(resolve_model_cfg(run), torch.Generator(),
                       torch.device("meta"), pal)
    j_local = TreeFlattener(tmpl).total
    dp = world(group)[0]
    return (sparsify.resolve_num_buckets(run.sparsifier, j_local, dp),
            j_local, dp)


def delta_publisher_for_run(run: RunConfig, params: dict, delta_k: int = 0,
                            *, record_history: bool = False):
    """The trainer's delta-broadcast publisher (``serve.delta``): its k is
    ``delta_k``, or for ``delta_k <= 0`` the sparsifier's k over the whole
    flat model (``sparsify.resolve_k``), so by default the serving channel
    ships what the gradient sync ships a step. Publish after each
    optimizer step; ship the version-0 base with ``write_snapshot``
    before a replica subscribes."""
    from repro_torch.core.flatten import tree_size
    from repro_torch.serve.delta import DeltaPublisher
    k = int(delta_k)
    if k <= 0:
        k = sparsify.resolve_k(run.sparsifier, tree_size(params))
    return DeltaPublisher(params, k, record_history=record_history)


def _model_axis(model_group) -> tuple[int, int]:
    """(tp, this rank's model index); (1, 0) without a model group."""
    return world(model_group) if model_group is not None else (1, 0)


# elements a rank sends in one gather of a checkpoint or a join: the
# card holds at most a group's worth of such chunks beside the live state
GATHER_CHUNK = 1 << 24


def _host_gather(leaf: torch.Tensor, group=None):
    """Every rank's ``leaf`` of ``group`` (None: the default group), in
    host memory on the group's rank 0 as one CPU tensor ``(n,) +
    leaf.shape`` in rank order; None on the other ranks. A collective of
    the group, made in gathers of GATHER_CHUNK elements a rank into one
    set of n device buffers, each chunk copied to the host before the
    next is gathered."""
    n, r = world(group)
    flat = leaf.detach().contiguous().reshape(-1)
    if n == 1:
        return flat.cpu().reshape((1,) + tuple(leaf.shape))
    dst = 0 if group is None else dist.get_global_rank(group, 0)
    out = bufs = None
    if r == 0:
        out = torch.empty((n, flat.numel()), dtype=leaf.dtype)
        bufs = [flat.new_empty(min(GATHER_CHUNK, flat.numel()))
                for _ in range(n)]
    for lo in range(0, flat.numel(), GATHER_CHUNK):
        piece = flat[lo:lo + GATHER_CHUNK]
        parts = None if bufs is None else [b[:piece.numel()] for b in bufs]
        dist.gather(piece, parts, dst=dst, group=group)
        for row, part in zip(out if r == 0 else (), parts or ()):
            row[lo:lo + part.numel()].copy_(part)
    return None if out is None else out.reshape((n,) + tuple(leaf.shape))


def joined_params(params: dict, model_group=None):
    """The global parameter tree (``convert.join_leaf`` of every model
    rank's leaf: a replicated leaf model rank 0's copy) in host memory on
    model rank 0 of ``model_group``, None on the others; ``params``
    itself without a model group. A collective of the model group that
    gathers a leaf at a time (:func:`_host_gather`), so no card holds a
    global copy."""
    from repro_torch.convert import join_leaf
    from repro_torch.core.flatten import tree_from_items
    tp, m = _model_axis(model_group)
    if tp == 1:
        return params
    items = []
    for path, leaf in tree_items(params):
        parts = _host_gather(leaf, model_group)
        if parts is not None:
            items.append((path, join_leaf(path, list(parts.unbind(0)))
                          .clone()))
    return tree_from_items(items) if m == 0 else None


def _global(leaf: torch.Tensor, group, model_group=None):
    """A rank's state leaf in the reference's global (DP, TP, ...) layout
    in host memory: every rank's slice, gathered on rank 0 (the other
    ranks get None; :func:`_host_gather`); a 0-d leaf (``step``, the same
    on every rank) as it is. Under tensor parallelism the ranks are the
    whole default group, data index r // tp and model index r % tp
    (``launch.mesh``)."""
    if leaf.ndim == 0:
        return leaf
    tp = _model_axis(model_group)[0]
    if tp > 1:
        group = None
    n = world(group)[0]
    if n == 1:
        return leaf.reshape((1, 1) + tuple(leaf.shape))
    rows = _host_gather(leaf, group)
    return None if rows is None else \
        rows.reshape((n // tp, tp) + tuple(leaf.shape))


def save_train_state(ckpt_dir: str, step: int, state: TrainState,
                     group=None, param_version=None, model_group=None):
    """Checkpoint a TrainState in the reference's file format and global
    layout: the parameters joined over the model group
    (``convert.join_leaf``), the optimizer's ZeRO-1 slices and the
    sparsifier states as ``(DP, TP, ...)``, gathered over the data and
    model groups and written by rank 0 (a collective: every rank calls
    it). Under tensor parallelism every model rank's copy of the
    replicated leaves goes beside them (``save_checkpoint``'s
    ``replicated``): the global tree holds model rank 0's, as the
    reference's does. Rank 0 gathers, joins and writes a leaf at a time
    in host memory (:func:`_host_gather`), so no card holds a global
    copy of any tree. Returns rank 0's path prefix."""
    from repro_torch.checkpoint.io import save_checkpoint
    from repro_torch.convert import join_leaf
    from repro_torch.models.specs import leaf_dim
    n, rank = world(group)
    tp, m = _model_axis(model_group)

    def params(replicated: bool):
        if rank:       # data rank 0's model group gathers the parameters
            return
        for path, leaf in tree_items(state.params):
            if tp == 1:
                yield path, leaf.detach()
                continue
            if replicated and leaf_dim(path, leaf.ndim) is not None:
                continue
            parts = _host_gather(leaf, model_group)
            if parts is not None:
                yield path, (parts if replicated else
                             join_leaf(path, list(parts.unbind(0))))

    def states(tree):
        for path, leaf in tree_items(tree):
            yield path, _global(leaf, group, model_group)

    # every rank draws the streams in this order, the writer as it writes
    streams = (params(False), states(state.opt), states(state.ef),
               params(True) if tp > 1 else None)
    path = None
    if rank == 0 and m == 0:
        path = save_checkpoint(ckpt_dir, step, *streams[:3],
                               param_version=param_version,
                               replicated=streams[3])
    else:
        for stream in streams:
            for _ in stream or ():
                pass
    if tp > 1:
        dist.barrier()
    elif n > 1:
        dist.barrier(group=group)
    return path


def restore_train_state(ckpt_dir: str, step: int, run: RunConfig,
                        device=None, group=None,
                        model_group=None) -> TrainState:
    """The TrainState of this rank from a checkpoint of either package:
    the parameters (under tensor parallelism the rank's share of each
    saved global leaf, ``convert.split_leaf``, or its own copy of a
    replicated leaf where the checkpoint holds them:
    ``checkpoint.io.load_replicated``), and the rank's row of the
    optimizer and sparsifier states. The rank's layout is the file's, so
    a checkpoint of ring attention (every rank all the heads) restores
    as one split by heads does. The file must hold the leaves of
    ``run``'s model, and its states the J_local its parameters give.
    Each leaf is read, cut and moved to ``device`` before the next is
    read; the states' templates are drawn on the ``meta`` device. The
    EF rows follow the saved worker count
    (``checkpoint.io._fit_ef_worker_dims``: a new rank starts from zero
    error feedback); the optimizer's rows must match the run's world."""
    from repro_torch.checkpoint.io import (load_items, load_leaves,
                                           load_replicated, to_tensor)
    from repro_torch.convert import split_leaf
    from repro_torch.core.flatten import tree_from_items
    dev = resolve_device(device)
    meta = torch.device("meta")
    tp, m = _model_axis(model_group)
    n, rank = world(group)[0], data_index(group)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    copies = load_replicated(path, tp) if tp > 1 else {}
    params = tree_from_items(
        (p, to_tensor(copies[p][m] if p in copies
                      else split_leaf(p, leaf, tp, m), None, dev))
        for p, leaf in load_items(path + ".params.npz"))
    want = {p for p, _ in tree_items(init_params(
        resolve_model_cfg(run), torch.Generator(), meta))}
    odd = sorted(want ^ {p for p, _ in tree_items(params)}, key=str)
    if odd:
        raise ValueError(f"checkpoint {path}: the leaves {odd[:4]} differ "
                         f"from {run.model.name}'s")
    j = TreeFlattener(params).total
    opt = init_opt_state(run.optimizer, torch.empty(opt_shard_len(j, n),
                                                    device=meta))
    ef = sparsify.init_state(run.sparsifier, j, meta)

    def load(tree, suffix, migrate_ef=False):
        rows = tree_map(lambda l: l if l.ndim == 0 else torch.empty(
            (n, tp) + tuple(l.shape), dtype=l.dtype, device=meta), tree)
        out = []
        for p, leaf, tmpl in load_leaves(path + suffix, rows, migrate_ef):
            if tmpl.ndim:
                if tuple(leaf.shape) != tuple(tmpl.shape):
                    raise ValueError(
                        f"checkpoint leaf {p} has shape {leaf.shape}; a "
                        f"world of {n} x {tp} wants {tuple(tmpl.shape)}")
                leaf = leaf[rank, m]
            out.append((p, to_tensor(leaf, None, dev)))
        return tree_from_items(out)

    return TrainState(_as_leaves(params), load(opt, ".opt.npz"),
                      load(ef, ".ef.npz", migrate_ef=True))
