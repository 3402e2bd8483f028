"""Gradient aggregation over the data-parallel process group (the port
of ``repro.core.aggregate``).

Three communication modes, as in the reference:

- ``dense``: the dense all-reduce of the raw gradient
  (``dense_allreduce``, the reference's ``pmean``): dense SGD (kind
  none) and the genie (kind globaltopk, whose top-k is taken of the
  aggregate) run it whatever mode was asked; a local or sketch selection
  asked for ``dense`` runs the simulate combine, as in the reference.
- ``sparse`` (local selection): every rank all-gathers the packed
  (value, index) pairs of every rank and scatter-adds them locally, one
  ``index_add_`` per rank in rank order, then scales by 1/n. With
  ``num_buckets`` > 1 the pairs travel in that many chunks, one
  all-gather each, chunk b + 1's issued before chunk b's scatter-adds
  (chunk by chunk, rank-major inside a chunk: the reference's order of
  addition at a duplicate index). ``wire_dtype="bfloat16"`` ships the
  values as bf16 (6 bytes a pair instead of 8) and widens them for the
  sum. Within a rank the live indices are distinct, so each
  ``index_add_`` is deterministic on the card too, and the rank-order
  sums reproduce the reference's: g_agg is identical on every rank,
  which REGTOP-k's posterior assumes.
- ``simulate``: every rank all-reduces its dense sparsified gradient
  ghat (a SUM, then the scale by 1/n: the reference's ``pmean``). Exact
  sparsified-training numerics at dense comm volume. A config whose
  compress step packs no fixed-size pairs (the reference pipeline's
  histogram selectors) runs it even when ``comm_mode="sparse"`` asks
  otherwise, with one RuntimeWarning per (kind, selector, pipeline).

Sketch selection (kind sketchtopk, DESIGN.md §2.9): each rank encodes
a = err + g into a CountSketch, one all-reduce averages the sketches,
every rank decodes the same magnitude estimates and so the same top-k,
and only the k values travel (``shared_mask_allgather_combine``,
n*k*4 bytes, or n*k*2 on the bf16 wire, in ``num_buckets`` chunks),
the error feedback closing by zeroing the shared indices of a; in
simulate mode the dense masked ghat (the mask through ``cfg.selector``)
is all-reduced instead.
Which path serves a config is the selection of
``core.sparsify.selection`` and the mode of
``kernels.compress.dispatch.effective_comm_mode``; nothing here branches
on ``cfg.kind``.

Elastic participation (``participate``: this rank's 0-d bool bit for the
step, from ``core.faults``). A sitting-out worker still ships its inert
payload, so every collective keeps its shape; the sparse combine
all-gathers each rank's liveness and live count beside the pairs and
routes dead slots to the sentinel j (``bigvec.live_idx``), the simulate
and dense combines all-reduce where(p, x, 0), and the normaliser is the
active count n_active (``combine="mean"``) or, per coordinate, the
number of active workers that selected it (``combine="support"``). A
worker whose packed values (or dense ghat) are not finite is dropped
for the step (the non-finite guard); ``with_stats`` reports
``n_active`` and ``dropped_nonfinite``. Under sketch selection a
sitting-out worker's sketch and values are zeros, both combines divide
by the active count, and its error keeps its decayed value.

Streaming (``cfg.overlap="backward"``, DESIGN.md §2.8):
:meth:`GradientSync.begin` opens a step that takes the gradient one
segment of a partition at a time, as the backward pass produces it; each
segment's sweeps launch as it is fed (on the allocated path its whole
sweep 1 -> threshold -> sweep 2 chain), and ``finish`` runs the joins,
the collective and ``observe_aggregate``: the flat call's bits.

Division by a worker count follows the compiled reference. XLA rewrites
a division by a constant into a multiply by its fp32 reciprocal, so a
mean over the static world size (``pmean``, the non-elastic combines,
the in-process rounds' ``/ n``) is ``x * (1 / n)``, which torch computes
the same way on the CPU and on the card. A count that is only known at
run time (n_active, the support counts) is a true division, by a 0-d
tensor on the data's device: torch turns a division by a host scalar
into a multiply by its reciprocal on the card.

Without an initialised process group the world is one rank; the same code
runs and gathers nothing. The in-process drivers (:meth:`GradientSync.
round`, :meth:`GradientSync.make_round_fn`) run N workers in one process
for the tests and the paper experiments; ``comm_bytes_per_step`` and
its two companions model the wire bytes of a config.
"""
from __future__ import annotations

import dataclasses
import functools
import operator
import warnings
from collections import Counter

import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.configs.base import SparsifierConfig
from repro_torch.core import bigvec, select, sketch, sparsify
from repro_torch.core.numerics import bf16, fma_f32
from repro_torch.kernels.compress import dispatch
from repro_torch.kernels.fused_ef.ops import fused_apply_mask
from repro_torch.models.parallel import world

# (kind, selector, pipeline) combos already warned about: the sparse ->
# simulate degrade is surfaced once per config per process
_DEGRADE_WARNED: set = set()
COMBINES = ("mean", "support")
WIRE_DTYPES = ("float32", "bfloat16")
COMM_MODES = ("sparse", "simulate", "dense")


def check_supported(cfg: SparsifierConfig) -> None:
    """The sync paths the port serves: ``sparsify.check_supported``'s
    gates, then ValueError for an unknown ``combine``, ``comm_mode`` or
    ``wire_dtype``."""
    sparsify.check_supported(cfg)
    if cfg.combine not in COMBINES:
        raise ValueError(f"unknown combine={cfg.combine!r} "
                         f"(expected one of {COMBINES})")
    if cfg.comm_mode not in COMM_MODES:
        raise ValueError(f"unknown comm_mode {cfg.comm_mode!r} (expected "
                         f"one of {COMM_MODES})")
    if cfg.wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {cfg.wire_dtype!r} (expected "
                         f"one of {WIRE_DTYPES})")


def _warn_sparse_degrade(cfg: SparsifierConfig) -> None:
    keyc = (cfg.kind, cfg.selector, cfg.pipeline)
    if keyc in _DEGRADE_WARNED:
        return
    _DEGRADE_WARNED.add(keyc)
    warnings.warn(
        f"comm_mode='sparse' with kind={cfg.kind!r} selector={cfg.selector!r}"
        f" pipeline={cfg.pipeline!r} packs no fixed-size (values, indices)"
        f" pairs (pipeline={cfg.pipeline!r} requested); degrading to a dense"
        " simulate all-reduce (effective_comm_mode(cfg) == 'simulate').",
        RuntimeWarning, stacklevel=3)


def _rank_sum(xs):
    """x_0 + x_1 + ... in rank order (no leading zero, as the compiled
    reference adds), so every rank computes the same sum."""
    return functools.reduce(operator.add, xs)


def _weighted_sum(ws, xs):
    """sum_i w_i * x_i in rank order, as the compiled reference computes
    a Python ``sum(w * x ...)``: XLA's CPU backend contracts each product
    that feeds an add into a fused multiply-add, the first add fusing
    w_0 * x_0 over the rounded w_1 * x_1 and every later add its own
    product (one rounding per term; the same bits as two roundings
    where the weights are powers of two)."""
    if xs[0].dtype == torch.bfloat16:
        # bf16 operands: the weights round to bf16, and each product and
        # each sum to bf16 (the rounding between them leaves nothing to
        # fuse)
        return _rank_sum([x * bf16(w) for w, x in zip(ws, xs)])
    if len(xs) == 1:
        return ws[0] * xs[0]
    acc = fma_f32(xs[0], ws[0], xs[1] * ws[1])
    for w, x in zip(ws[2:], xs[2:]):
        acc = fma_f32(x, w, acc)
    return acc


def _n(n: int, like: torch.Tensor) -> torch.Tensor:
    """The worker count n as a 0-d fp32 tensor on like's device."""
    return torch.full((), n, dtype=torch.float32, device=like.device)


def _mean_scale_(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n for the static worker count n, in place, as the compiled
    reference computes it: x * fp32(1/n) (XLA rewrites the division by a
    constant; the two agree where n is a power of two)."""
    return x.mul_(1.0 / n)


def _active_mean(x: torch.Tensor, p: torch.Tensor, group) -> torch.Tensor:
    """The elastic mean of the reference's dense and simulate combines:
    the SUM all-reduce of where(p, x, 0), divided by max(n_active, 1)."""
    n, _ = world(group)
    dsum = torch.where(p, x, 0.0)
    na = p.to(x.dtype)
    if n > 1:
        dist.all_reduce(dsum, group=group)
        dist.all_reduce(na, group=group)
    return dsum / na.clamp(min=1.0)


def wire_span(name: str, x: torch.Tensor, **attrs):
    """The ``trace`` span of one collective of the sync (``sync/*``)
    whose part on this rank is ``x``, with ``attrs``, and the step's
    counter ``sync_bytes`` grown by x's bytes (attribute ``collective``:
    the span's name); the shared no-op context while tracing is off."""
    if not trace.enabled():
        return trace.OFF
    nbytes = x.numel() * x.element_size()
    trace.count("sync_bytes", nbytes, collective=name)
    return trace.span(name, bytes=nbytes, **attrs)


def _gather(x: torch.Tensor, group, name: str) -> list:
    n, _ = world(group)
    if n == 1:
        return [x]
    out = [torch.empty_like(x) for _ in range(n)]
    with wire_span(name, x):
        dist.all_gather(out, x, group=group)
    return out


def dense_allreduce(g: torch.Tensor, group=None) -> torch.Tensor:
    """g_agg = (1/n) sum_ranks g_r (the reference's ``pmean``) into a new
    buffer: the caller's gradient is left as it is; over one rank the
    identity, with no copy."""
    n, _ = world(group)
    if n == 1:
        return g
    return simulate_allreduce(g.clone(), group)


def simulate_allreduce(ghat: torch.Tensor, group=None) -> torch.Tensor:
    """g_agg = (1/n) sum_ranks ghat_r: a SUM all-reduce, then the scale by
    1/n (the reference's ``pmean``), in place on ``ghat``; over one rank
    the identity."""
    n, _ = world(group)
    if n == 1:
        return ghat
    dist.all_reduce(ghat, op=dist.ReduceOp.SUM, group=group)
    return _mean_scale_(ghat, n)


def sparse_allgather_combine(values: torch.Tensor, indices: torch.Tensor,
                             j: int, group=None, participate=None,
                             count=None, combine: str = "mean",
                             num_buckets: int = 1,
                             wire_dtype: str = "float32") -> torch.Tensor:
    """g_agg = (1/n) sum_ranks scatter(values_r, indices_r), rank-identical.

    The packed pairs travel in ``num_buckets`` chunks (one when there
    are no more pairs than chunks; the last chunk padded with inert
    pairs, 0.0 at index 0), one all-gather each: chunk b + 1's is in
    flight while chunk b is scatter-added, rank by rank. The values go
    on the wire as ``wire_dtype`` and are summed in fp32.

    Elastic (``participate`` this rank's 0-d bool bit, ``count`` its live
    packed prefix, None = all of them; or ``combine="support"``): one
    more all-gather of each rank's (liveness, live count); a rank's
    slots past its count, or all of them when it sits out, go to the
    sentinel j and drop; the sum is divided by the active count, or per
    coordinate by the number of active ranks that selected it
    (``support``; coordinates nobody selected stay 0)."""
    n, _ = world(group)
    dev, k = values.device, values.numel()
    nb = max(1, int(num_buckets))
    if k <= nb:
        nb = 1                   # one pair a chunk would gain nothing
    chunk = -(-k // nb)
    pad = chunk * nb - k
    if pad:
        values = torch.cat([values, values.new_zeros(pad)])
        indices = torch.cat([indices, indices.new_zeros(pad)])
    elastic = participate is not None or combine != "mean"
    if elastic:
        p = (torch.ones((), dtype=torch.bool, device=dev)
             if participate is None else participate.reshape(()))
        cnt = torch.full((), k, dtype=torch.int64, device=dev) \
            if count is None else count.reshape(()).to(torch.int64)
        metas = _gather(torch.stack([p.to(torch.int64),
                                     torch.where(p, cnt, 0)]), group,
                        "sync/allgather_meta")
    dense = torch.zeros(j + 1 if elastic else j, dtype=values.dtype,
                        device=dev)
    counts = (torch.zeros(j + 1, dtype=torch.float32, device=dev)
              if combine == "support" else None)
    wire = getattr(torch, wire_dtype)

    def gather_chunk(b: int):
        sl = slice(b * chunk, (b + 1) * chunk)
        return (_gather_async(values[sl].to(wire), group,
                              "sync/allgather_values", chunk=b),
                _gather_async(indices[sl], group, "sync/allgather_indices",
                              chunk=b))

    pending = gather_chunk(0)
    for b in range(nb):
        ahead = gather_chunk(b + 1) if b + 1 < nb else None
        vals, idx = (_wait(x, n) for x in pending)
        pos = torch.arange(b * chunk, (b + 1) * chunk, device=dev)
        for r in range(n):
            v = vals[r].to(values.dtype)
            i = idx[r]
            if elastic:
                m = metas[r]
                i = bigvec.live_idx(i, (m[0] > 0) & (pos < m[1]), j)
            bigvec.scatter_add_(dense, i, v)
            if counts is not None:
                counts.index_add_(0, i, torch.ones_like(v))
        pending = ahead
    if not elastic:
        return _mean_scale_(dense, n)
    dense = dense[:j]
    if counts is not None:
        counts = counts[:j]
        return torch.where(counts > 0, dense / counts.clamp(min=1.0), 0.0)
    n_active = _rank_sum([m[0].to(torch.float32) for m in metas])
    return dense.div_(n_active.clamp(min=1.0))


def _gather_async(x: torch.Tensor, group, name: str, chunk: int = 0):
    """Start the all-gather of x (n * x.numel(),) and return (out, work);
    over one rank x itself and no work. ``name`` is its ``sync/*`` span
    (the launch), ``chunk`` the wire chunk it carries."""
    n, _ = world(group)
    if n == 1:
        return x, None
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    with wire_span(name, x, chunk=chunk):
        work = dist.all_gather_into_tensor(out, x, group=group,
                                           async_op=True)
    return out, work


def _wait(pending, n: int) -> torch.Tensor:
    """The (n, chunk) result of :func:`_gather_async`, once it is in."""
    out, work = pending
    if work is not None:
        work.wait()
    return out.view(n, -1)


def shared_mask_allgather_combine(values: torch.Tensor, indices: torch.Tensor,
                                  j: int, group=None, num_buckets: int = 1,
                                  wire_dtype: str = "float32",
                                  participate=None,
                                  acc_dtype=None) -> torch.Tensor:
    """g_agg under a shared mask: every rank holds the same ``indices``,
    so only the (k,) values are all-gathered, in ``num_buckets`` chunks
    of ceil(k / num_buckets) (one when there are no more values than
    chunks; the last chunk padded with 0.0 at the shared index 0, whose
    scatter-add turns a -0.0 there into +0.0), chunk b + 1's gather
    issued before chunk b's scatter. The values go on the wire as
    ``wire_dtype``; each chunk is summed over the ranks in rank order in
    fp32 and rounded once to ``acc_dtype`` (by default the values'
    dtype; ``jnp.sum`` widens a bf16 sum), scattered into zeros of it
    and divided by n, or under
    ``participate`` (this rank's 0-d bit; a sitting-out rank's values
    arrive zeroed) by max(n_active, 1). Under the shared mask the
    support combine is this mean."""
    n, _ = world(group)
    dev, k = values.device, values.numel()
    nb = max(1, int(num_buckets))
    if k <= nb:
        nb = 1
    chunk = -(-k // nb)
    pad = chunk * nb - k
    if pad:
        values = torch.cat([values, values.new_zeros(pad)])
        indices = torch.cat([indices, indices.new_zeros(pad)])
    acc = values.dtype if acc_dtype is None else acc_dtype
    wire = getattr(torch, wire_dtype)
    dense = torch.zeros(j, dtype=acc, device=dev)

    def gather_chunk(b: int):
        return _gather_async(values[b * chunk:(b + 1) * chunk].to(wire),
                             group, "sync/allgather_values", chunk=b)

    pending = gather_chunk(0)
    for b in range(nb):
        ahead = gather_chunk(b + 1) if b + 1 < nb else None
        vals = _wait(pending, n).float()
        vsum = _rank_sum(list(vals)).to(acc)
        bigvec.scatter_add_(dense, indices[b * chunk:(b + 1) * chunk], vsum)
        pending = ahead
    if participate is None:
        return _mean_scale_(dense, n)
    na = participate.reshape(()).to(torch.float32)
    if n > 1:
        with wire_span("sync/allreduce_active", na):
            dist.all_reduce(na, group=group)
    return dense.div_(na.clamp(min=1.0).to(acc))


def _bits(participate, dev):
    """One 0-d bool tensor on ``dev`` a worker (None stays None)."""
    if participate is None:
        return None
    return [torch.as_tensor(p, dtype=torch.bool).to(dev).reshape(())
            for p in participate]


def _masked_mean(xs: list, pfs: list) -> torch.Tensor:
    """sum_i where(p_i, x_i, 0) in worker order, divided by
    max(n_active, 1): the in-process rounds' elastic mean."""
    na = _rank_sum([p.to(torch.float32) for p in pfs])
    return _rank_sum([torch.where(p, x, 0.0) for p, x in zip(pfs, xs)]) \
        / na.clamp(min=1.0)


def _guard(p: torch.Tensor, payload: torch.Tensor):
    """(p_eff, dropped): the participation bit with a non-finite payload
    dropped, and 1.0 where the guard dropped a participant (0-d)."""
    finite = torch.isfinite(payload).all()
    return p & finite, (p & ~finite).to(torch.float32)


class GradientSync:
    """Per-run gradient-sync surface: the config is validated once here,
    each step calls the object with the state and the flat gradient.
    ``fallback_reasons`` counts the compress calls whose trim took the
    exact dense fallback, by reason;
    ``last_count`` is the last local step's live packed count (a 0-d
    device tensor; None where every packed slot is live).

    ``comm`` is the communication mode the sync realizes
    (``dispatch.effective_comm_mode``).

    The sketch-coordinated step is three calls, so a caller can feed one
    sketch to two devices: :meth:`encode`, :meth:`allreduce_sketch` and
    :meth:`decode_exchange`. ``sketch_tables`` keeps the encode kernels'
    start table of each shape on the card (built at the first step, 142
    MB at StableLM-3B's J; either pipeline's) for as long as the sync
    lives.

    ``seg_bounds`` pins the allocation's segments (the train step passes
    layer-aligned ones); ``stream_bounds`` the partition a streaming step
    (:meth:`begin`, ``cfg.overlap="backward"``) is fed in, by default the
    allocation's segments. Allocation and overlap are checked here, at
    build time (the reference's ValueErrors).

    ``num_buckets=0`` (the bucket auto-tune) resolves here when ``j``,
    the flat length, is given, else at the first step, from J and the
    group's size (``sparsify.resolve_num_buckets``); ``cfg`` is then the
    resolved config and ``requested`` the one asked for."""

    def __init__(self, cfg: SparsifierConfig, group=None, *, j: int = None,
                 seg_bounds=None, stream_bounds=None):
        check_supported(cfg)
        self.requested = cfg
        self.cfg = cfg
        self.j = None
        self.group = group
        self.seg_bounds = (None if seg_bounds is None
                           else [tuple(b) for b in seg_bounds])
        if stream_bounds is None and cfg.overlap == "backward":
            stream_bounds = self.seg_bounds
        self.stream_bounds = (None if stream_bounds is None
                              else [tuple(b) for b in stream_bounds])
        self.selection = sparsify.selection(cfg)
        self.comm = dispatch.effective_comm_mode(cfg)
        self.fallback_reasons: Counter = Counter()
        self.last_count = None
        self.sketch_tables: dict = {}
        if j is not None:
            self._resolve(j)

    def _resolve(self, j: int) -> None:
        """Resolve ``num_buckets=0`` for a flat length j over the group,
        as the reference's sync does at build time or at the step (the
        baselines select nothing and keep the config)."""
        if (self.requested.num_buckets != 0 or j == self.j
                or self.selection == "none"):
            return
        self.cfg = dataclasses.replace(
            self.requested, num_buckets=sparsify.resolve_num_buckets(
                self.requested, j, world(self.group)[0]))
        self.j = j

    def _count(self, outs) -> None:
        for out in outs:
            if out.fallback:
                self.fallback_reasons[out.fallback] += 1

    def __call__(self, state: dict, g: torch.Tensor, participate=None,
                 donate: bool = False, with_stats: bool = False, key=None):
        """One flat-gradient sync step: returns (g_agg, new_state), and
        with ``with_stats`` also {"n_active", "dropped_nonfinite"} (0-d
        fp32, rank-identical). ``participate`` is this rank's 0-d bool
        participation bit (None: always in). ``donate=True`` hands the
        old state to the compressor, which frees its J-vectors as soon
        as it has read them (the caller must not use ``state`` again).
        ``key`` is randk's (2,) threefry key for this rank's step."""
        n, _ = world(self.group)
        if self.selection in ("none", "global"):
            p = None if participate is None else participate.reshape(())
            g_agg = self._sync_dense(g, p)
            new = {"step": state["step"] + 1}
            if not with_stats:
                return g_agg, new
            zero = None if p is None else torch.zeros((), device=g.device)
            return g_agg, new, self._stats(p, zero, g_agg)
        self._resolve(g.numel())
        if self.selection == "sketch":
            p = None if participate is None else participate.reshape(())
            a, sk = self.encode(state, g, p)
            g_agg, new, _ = self.decode_exchange(
                self.allreduce_sketch(sk, p), a, state, p)
            if not with_stats:
                return g_agg, new
            zero = None if p is None else torch.zeros((), device=g.device)
            return g_agg, new, self._stats(p, zero, g_agg)
        j = g.numel()
        p = None if participate is None else participate.reshape(())
        segs = None
        if self.stream_bounds is not None and self.cfg.overlap == "backward":
            # the stream's own partition (the flat call is its bits)
            segs = [g[off:off + size] for off, size in self.stream_bounds]
            g = None
        out = sparsify.compress(self.cfg, state, g, omega=1.0 / n,
                                donate=donate, participate=p, key=key,
                                seg_bounds=self.seg_bounds, g_segments=segs)
        return self._close(out, j, p, with_stats)

    def begin(self, state: dict, *, key=None, participate=None):
        """Open a streaming step (``cfg.overlap="backward"`` only): feed
        the gradient's segments with ``feed_segment`` as the backward pass
        produces them, then ``finish()`` runs the trim, the collective and
        ``observe_aggregate``. Bit for bit the flat call's result."""
        if self.cfg.overlap != "backward":
            raise ValueError(
                "begin()/feed_segment streaming needs overlap='backward' "
                f"(got overlap={self.cfg.overlap!r})")
        self._resolve(state[sparsify.err_key(self.cfg)].numel())
        return _GradientStream(self, state, key, participate)

    def _close(self, out, j: int, p, with_stats: bool):
        """The rest of a local-selection step from the compressor's
        output: the combine, observe_aggregate and the stats."""
        self._count([out])
        self.last_count = out.count
        p_eff = dropped = None
        if p is not None and out.values is not None:
            # the non-finite guard: a worker whose packed values went
            # NaN or Inf is dropped for the step (its error feedback has
            # been updated as a participant's: a one-step posterior skew)
            p_eff, dropped = _guard(p, out.values)
        elastic = p is not None or self.cfg.combine != "mean"
        if self.comm == "sparse":
            with trace.span("sync/combine"):
                wire = dict(num_buckets=self.cfg.num_buckets,
                            wire_dtype=self.cfg.wire_dtype)
                g_agg = sparse_allgather_combine(
                    out.values, out.indices, j, self.group,
                    participate=p_eff, count=out.count,
                    combine=self.cfg.combine, **wire) if elastic else \
                    sparse_allgather_combine(out.values, out.indices, j,
                                             self.group, **wire)
        else:
            if self.cfg.comm_mode == "sparse":
                _warn_sparse_degrade(self.cfg)
            with trace.span("sync/simulate"):
                ghat = sparsify.dense_ghat(out, j)
                if p is not None and out.values is None:
                    p_eff, dropped = _guard(p, ghat)
                g_agg = (self._simulate_elastic(out, ghat, p_eff, j)
                         if elastic else simulate_allreduce(ghat, self.group))
        new = sparsify.observe_aggregate(self.cfg, out.state, g_agg,
                                         participate=p_eff)
        if not with_stats:
            return g_agg, new
        return g_agg, new, self._stats(p_eff, dropped, g_agg)

    def _sync_dense(self, g: torch.Tensor, p) -> torch.Tensor:
        """The baselines' step: the dense all-reduce of the gradient (its
        elastic mean under a mask), in the error-feedback dtype for dense
        SGD (a bf16 all-reduce under ``ef_dtype="bfloat16"``) and in fp32
        for the genie, which then keeps the top-k of the aggregate, as
        mask * a_agg (a multiply, so an unselected negative entry is
        -0.0, as in the reference)."""
        gf = g.to(sparsify.state_dtype(self.cfg)
                  if self.selection == "none" else torch.float32)
        with trace.span("sync/dense"):
            agg = (dense_allreduce(gf, self.group) if p is None
                   else _active_mean(gf, p, self.group))
        if self.selection == "none":
            return agg
        with trace.span("sync/select"):
            k = sparsify.resolve_k(self.cfg, agg.numel())
            return select.topk_mask(agg, k, self.cfg.selector) * agg

    def _simulate_elastic(self, out, ghat, p_eff, j: int) -> torch.Tensor:
        """The simulate combine under participation or the support
        rule: the SUM all-reduce of where(p, ghat, 0), divided by the
        active count or by each coordinate's active selection count."""
        pe = (torch.ones((), dtype=torch.bool, device=ghat.device)
              if p_eff is None else p_eff)
        if self.cfg.combine == "support":
            n, _ = world(self.group)
            dsum = torch.where(pe, ghat, 0.0)
            cnts = torch.where(pe, sparsify.dense_mask(out, j), 0.0)
            if n > 1:
                dist.all_reduce(dsum, group=self.group)
                dist.all_reduce(cnts, group=self.group)
            return torch.where(cnts > 0, dsum / cnts.clamp(min=1.0), 0.0)
        return _active_mean(ghat, pe, self.group)

    def _stats(self, p_eff, dropped, like) -> dict:
        """{"n_active", "dropped_nonfinite"}: the sums over ranks of the
        effective participation bits and of the guard's drops (the world
        size and 0 without a mask)."""
        n, _ = world(self.group)
        if p_eff is None:
            return {"n_active": _n(n, like),
                    "dropped_nonfinite": torch.zeros((), device=like.device)}
        both = torch.stack([p_eff.to(torch.float32), dropped])
        if n > 1:
            dist.all_reduce(both, group=self.group)
        return {"n_active": both[0], "dropped_nonfinite": both[1]}

    # -- sketch coordination --------------------------------------------

    def _k_width(self, j: int) -> tuple[int, int]:
        k = sparsify.resolve_k(self.cfg, j)
        return k, sketch.resolve_width(k, self.cfg.sketch_width)

    def encode(self, state: dict, g: torch.Tensor, participate=None, *,
               round_form: bool = False):
        """(a fp32, sketch of a) for this worker's step; ``participate``
        masks the inputs (g_eff = where(p, g, 0), err_eff = where(p, err,
        err_decay * err)). The fused pipeline makes one pass through
        ``sweep1_sketch`` (its gated form under a bit, its bf16 read
        under a bf16 state). The reference pipeline adds err + g in fp32
        (g rounded to the state's dtype first, as the reference's
        per-step sync casts it; with ``round_form`` as its in-process
        round does, g as it is), then runs the ``sketch_encode``
        kernel."""
        cfg = self.cfg
        _, width = self._k_width(g.numel())
        err = state[sparsify.err_key(cfg)]
        p = None if participate is None else participate.reshape(())
        with trace.span("sketch/encode"):
            if sparsify.fused(cfg):
                from repro_torch.kernels.compress import ops
                enc = ops.fused_sketch_encode(
                    g.float(), err, rows=cfg.sketch_rows, width=width,
                    tables=self.sketch_tables, participate=p,
                    err_decay=cfg.err_decay)
                return enc["a"], enc["sketch"]
            g = g.float()
            if p is not None:
                from repro_torch.kernels.compress.kernel import masked_inputs
                g, err = masked_inputs(g, err, p, cfg.err_decay)
            g = g.to(torch.float32 if round_form else err.dtype)
            # under a bf16 state every consumer of a widens it (the
            # encode, the fp32 mask's product, the fp32 wire), which in
            # the compiled reference absorbs the add's rounding: a is
            # the fp32 sum, rounded only where it is stored
            a = err.float() + g.float()
            return a, sketch.encode(a, cfg.sketch_rows, width,
                                    self.sketch_tables)

    def allreduce_sketch(self, sk: torch.Tensor,
                         participate=None) -> torch.Tensor:
        """The pre-selection collective: the mean of the ranks' sketches
        (in place on ``sk``); under ``participate`` a sitting-out rank
        adds a zero sketch and the sum is divided by max(n_active, 1)."""
        n, _ = world(self.group)
        with trace.span("sketch/allreduce"):
            if participate is not None:
                return _active_mean(sk, participate.reshape(()), self.group)
            if n > 1:
                dist.all_reduce(sk, op=dist.ReduceOp.SUM, group=self.group)
            return _mean_scale_(sk, n)

    def decode(self, sk_agg: torch.Tensor, j: int) -> torch.Tensor:
        """The shared top-k indices (int64, lax.top_k order) of the
        magnitude estimates decoded from the mean sketch (the sparse
        exchange's decode, exact whatever the selector)."""
        k, _ = self._k_width(j)
        with trace.span("sketch/estimate"):
            gmag = sketch.estimate(sk_agg, j)
        with trace.span("sketch/select"):
            return select.topk_indices(gmag, k)

    def decode_mask(self, sk_agg: torch.Tensor, j: int) -> torch.Tensor:
        """The shared 0/1 mask (fp32) of the magnitude estimates through
        ``cfg.selector``, as the simulate exchange and the in-process
        round decode it."""
        k, _ = self._k_width(j)
        with trace.span("sketch/estimate"):
            gmag = sketch.estimate(sk_agg, j)
        with trace.span("sketch/select"):
            return select.topk_mask(gmag, k, self.cfg.selector)

    def decode_exchange(self, sk_agg: torch.Tensor, a: torch.Tensor,
                        state: dict, participate=None):
        """Decode the shared selection from the mean sketch and combine.
        Sparse comm: exchange the k selected values of a (zeros from a
        sitting-out worker; in ``num_buckets`` chunks as ``wire_dtype``)
        and close the error feedback in O(k): a, in the state's dtype,
        with the shared indices zeroed (none for a sitting-out worker,
        whose decayed error stays). Simulate comm: the shared mask
        through ``cfg.selector``, ghat and the error state through the
        apply kernel (ghat zeroed and the error a itself for a
        sitting-out worker), and the dense all-reduce. Returns (g_agg,
        new_state, the shared indices or, in simulate mode, the shared
        mask)."""
        cfg = self.cfg
        j = a.numel()
        key = sparsify.err_key(cfg)
        dt = state[key].dtype
        p = None if participate is None else participate.reshape(())
        if self.comm == "sparse":
            idx = self.decode(sk_agg, j)
            with trace.span("sync/combine"):
                vals = a[idx]
                if p is not None:
                    vals = torch.where(p, vals, 0.0)
                # the reference sums in its values' dtype: the state's
                # on the reference pipeline, fp32 on the fused one
                g_agg = shared_mask_allgather_combine(
                    vals, idx, j, self.group, cfg.num_buckets,
                    cfg.wire_dtype, p,
                    torch.float32 if sparsify.fused(cfg) else dt)
                err = bigvec.scatter_set_live_(a.to(dt), idx, p, 0.0)
            return g_agg, {key: err, "step": state["step"] + 1}, idx
        mask = self.decode_mask(sk_agg, j)
        with trace.span("sync/simulate"):
            ghat, err = fused_apply_mask(a, mask)
            if p is None:
                g_agg = simulate_allreduce(ghat, self.group)
            else:
                ghat = torch.where(p, ghat, 0.0)
                err = torch.where(p, err, a.float())
                g_agg = _active_mean(ghat, p, self.group)
        return g_agg, {key: err.to(dt), "step": state["step"] + 1}, mask

    # -- in-process simulation ------------------------------------------

    def round(self, states: list, grads: list, omegas=None,
              participate=None, key=None):
        """One aggregation round over N in-process workers (the
        reference's ``GradientSync.round``): returns (g_agg, new_states).
        ``participate``: one bit per worker (bools or 0-d bool tensors);
        then the combine is the elastic one of the per-step path, over
        equal weights 1/n (``omegas`` is not used). ``key``: randk's
        threefry key, worker i drawing with ``fold_in(key, i)``."""
        if self.selection == "sketch":
            return self._round_sketch(states, grads, omegas, participate)
        if self.selection == "global":
            return self._round_global(states, grads, omegas, participate)
        if participate is not None:
            return self._round_elastic(states, grads, participate, key)
        n = len(grads)
        omegas = omegas or [1.0 / n] * n
        j = grads[0].numel()
        outs = [sparsify.compress(self.cfg, s, g, omega=w,
                                  key=_worker_key(key, i))
                for i, (s, g, w) in enumerate(zip(states, grads, omegas))]
        self._count(outs)
        # rank order without a leading zero, as the compiled reference
        # sums (its ``0 +`` is dropped, which keeps the sign of -0.0)
        g_agg = _weighted_sum(omegas, [sparsify.dense_ghat(o, j)
                                       for o in outs])
        return g_agg, [sparsify.observe_aggregate(self.cfg, o.state, g_agg)
                       for o in outs]

    def _round_elastic(self, states: list, grads: list, participate: list,
                       key=None):
        """round() under a participation mask (the reference's
        ``_round_elastic``): inert payloads from sitting-out workers, the
        sum over workers divided by n_active ("mean") or per coordinate
        by the selection counts ("support"). An all-absent round gives
        g_agg = 0, and every state decays."""
        n = len(grads)
        j = grads[0].numel()
        pfs = _bits(participate, grads[0].device)
        outs = [sparsify.compress(self.cfg, s, g, omega=1.0 / n,
                                  participate=p, key=_worker_key(key, i))
                for i, (s, g, p) in enumerate(zip(states, grads, pfs))]
        self._count(outs)
        ghats = [sparsify.dense_ghat(o, j) for o in outs]
        if self.cfg.combine == "support":
            counts = _rank_sum([sparsify.dense_mask(o, j) for o in outs])
            g_agg = torch.where(counts > 0, _rank_sum(ghats)
                                / counts.clamp(min=1.0), 0.0)
        else:
            # an fp32 count: a bf16 sum is widened for the division, and
            # the compiled reference computes its last add in fp32 with
            # no rounding to bf16 (the widening absorbs it)
            n_active = _rank_sum([p.to(torch.float32) for p in pfs])
            dense = ghats[-1].float()
            if len(ghats) > 1:
                dense = _rank_sum(ghats[:-1]).float() + dense
            g_agg = dense / n_active.clamp(min=1.0)
        return g_agg, [sparsify.observe_aggregate(self.cfg, o.state, g_agg,
                                                  participate=p)
                       for o, p in zip(outs, pfs)]

    def _round_sketch(self, states, grads, omegas, participate=None):
        """Per-worker encode (the in-process round's fp32 a on the
        reference pipeline), one sketch combine, one shared mask through
        ``cfg.selector``, each worker's error feedback closed at that mask
        (dense form, as the reference's ``_round_sketch``). Under
        ``participate`` a sitting-out worker's inputs are masked, its
        sketch and ghat are zeros and both combines divide by max(n_active,
        1); explicit ``omegas`` with a mask raise, as in the reference."""
        if participate is not None and omegas is not None:
            raise ValueError(
                "explicit omegas with a participation mask are not "
                "defined for sketch coordination — the elastic combine "
                "renormalizes equal weights over the active set")
        pfs = _bits(participate, grads[0].device)
        encs = [self.encode(s, g, None if pfs is None else pfs[i],
                            round_form=True)
                for i, (s, g) in enumerate(zip(states, grads))]
        sk_agg = self.mean_sketch([sk for _, sk in encs], omegas, pfs)
        g_agg, new, _ = self.close_sketch_round(states, [a for a, _ in encs],
                                                sk_agg, omegas, pfs)
        return g_agg, new

    @staticmethod
    def mean_sketch(sketches: list, omegas=None,
                    participate=None) -> torch.Tensor:
        """The in-process round's combine of the workers' sketches: their
        mean (the rank-order sum scaled by 1/n), their omega-weighted
        sum, or under ``participate`` (one 0-d bit a worker) the sum of
        the active ones divided by max(n_active, 1)."""
        if participate is not None:
            return _masked_mean(sketches, participate)
        if omegas is None:
            return _rank_sum(sketches) * (1.0 / len(sketches))
        return _weighted_sum(omegas, sketches)

    def close_sketch_round(self, states: list, a_list: list,
                           sk_agg: torch.Tensor, omegas=None,
                           participate=None):
        """The rest of a sketch round from the combined sketch: the shared
        mask through ``cfg.selector``, every worker's ghat and error
        through the apply kernel (ghat zeroed and the error a itself for
        a sitting-out worker), and g_agg; returns (g_agg, new_states,
        the shared mask). A caller may hand two devices the same
        ``sk_agg``."""
        j = a_list[0].numel()
        mask = self.decode_mask(sk_agg, j)
        applied = [fused_apply_mask(a, mask) for a in a_list]
        ghats = [gh for gh, _ in applied]
        errs = [err for _, err in applied]
        if participate is not None:
            ghats = [torch.where(p, gh, 0.0)
                     for p, gh in zip(participate, ghats)]
            errs = [torch.where(p, err, a.float())
                    for p, err, a in zip(participate, errs, a_list)]
            g_agg = _masked_mean(ghats, participate)
        elif omegas is None:
            g_agg = _rank_sum(ghats) * (1.0 / len(ghats))
        else:
            g_agg = _weighted_sum(omegas, ghats)
        key = sparsify.err_key(self.cfg)
        return g_agg, [{key: err.to(st[key].dtype), "step": st["step"] + 1}
                       for err, st in zip(errs, states)], mask

    def _round_global(self, states, grads, omegas, participate):
        """The genie's round (the reference's ``_round_global``): the
        top-k mask of the true aggregate, returned as mask * a_agg; the
        states pass through (the genie keeps no error feedback). Under a
        mask the aggregate is the mean over the active workers; explicit
        ``omegas`` with a mask raise, as in the reference."""
        n = len(grads)
        gfs = [g.float() for g in grads]
        if participate is not None:
            if omegas is not None:
                raise ValueError(
                    "explicit omegas with a participation mask are not "
                    "defined for the genie baseline — the elastic "
                    "combine renormalizes equal weights over the active "
                    "set")
            a_agg = _masked_mean(gfs, _bits(participate, gfs[0].device))
        elif omegas is None:
            a_agg = _rank_sum(gfs) * (1.0 / n)
        else:
            a_agg = _weighted_sum(omegas, gfs)
        k = sparsify.resolve_k(self.cfg, a_agg.numel())
        return select.topk_mask(a_agg, k, self.cfg.selector) * a_agg, states

    def make_round_fn(self, n_workers: int):
        """The reference's ``make_round_fn``: a round over stacked worker
        states (leading axis N) and grads (N, J) with equal weights
        omega = 1/N, returning (g_agg, new stacked states). Local
        selection compresses worker by worker (a Python loop stands for
        the reference's vmap, which the kernels do not take) and sums the
        ghats as the compiled ``jnp.sum(ghats, 0) * omega`` does: in
        worker order from a leading +0.0, then one multiply by omega
        (round() instead sums the products w * ghat without a leading
        zero, and the port follows each). Coordinated selection (sketch,
        genie) unstacks, delegates to :meth:`round` and restacks, as the
        reference's ``round_coord`` does."""
        omega = 1.0 / n_workers

        if self.selection in ("sketch", "global"):
            def round_coord(states: dict, grads: torch.Tensor):
                n = grads.shape[0]
                g_agg, new = self.round(sparsify.unstack_states(states, n),
                                        list(grads))
                return g_agg, sparsify.stack_states(new)
            return round_coord

        def round_fn(states: dict, grads: torch.Tensor, key=None):
            n, j = grads.shape
            outs = [sparsify.compress(self.cfg, st, g, omega=omega,
                                      key=_worker_key(key, i))
                    for i, (st, g) in enumerate(zip(
                        sparsify.unstack_states(states, n), grads))]
            self._count(outs)
            ghats = [sparsify.dense_ghat(out, j) for out in outs]
            total = torch.zeros(j, dtype=torch.float32, device=grads.device)
            for ghat in ghats:
                total = total + ghat
            if ghats[0].dtype == torch.bfloat16:
                # jnp.sum widens a bf16 sum to fp32 and rounds it once;
                # the weak-typed omega rounds to bf16
                g_agg = total.to(torch.bfloat16) * bf16(omega)
            else:
                g_agg = total * omega
            return g_agg, sparsify.stack_states(
                [sparsify.observe_aggregate(self.cfg, o.state, g_agg)
                 for o in outs])
        return round_fn


class _GradientStream:
    """A streaming step of :meth:`GradientSync.begin`. Its partition is
    the sync's ``stream_bounds``, else the flat call's (the allocation's
    segments, else the near-equal cut). ``feed_segment`` takes one
    segment of it (the next in order, or the one at ``offset``, in any
    order) and launches its sweeps at once, on the caller's current CUDA
    stream; ``finish`` is the only barrier: the joins of the compressor,
    the collective, observe_aggregate. Single-shot."""

    def __init__(self, sync: GradientSync, state: dict, key, participate):
        self._gs = sync
        p = None if participate is None else participate.reshape(())
        self._p = p
        self._next = 0
        self._fed = 0
        self._done = False
        n, _ = world(sync.group)
        j = state[sparsify.err_key(sync.cfg)].numel()
        bounds = sync.stream_bounds or sparsify.partitions(
            sync.cfg, j, sync.seg_bounds)[1]
        self._step = sparsify.begin_fused(
            sync.cfg, state, j, 1.0 / n, participate=p, key=key,
            seg_bounds=sync.seg_bounds, stream_bounds=bounds)
        self._pos = {off: (i, size)
                     for i, (off, size) in enumerate(self._step.bounds)}

    def feed_segment(self, g_seg: torch.Tensor, offset: int = None):
        """Add one flat gradient segment: the next one in order, or the one
        at ``offset`` of the stream's partition."""
        if self._done:
            raise RuntimeError("feed_segment() after finish()")
        if offset is None:
            offset = self._next
        pos, size = self._pos.get(offset, (None, None))
        if pos is None or size != g_seg.numel():
            raise ValueError(f"no segment of {g_seg.numel()} elements at "
                             f"offset {offset} in the stream's partition")
        self._step.feed(pos, g_seg)
        self._next = offset + size
        self._fed += 1
        return self

    def side_outputs(self) -> list:
        """The tensors the feeds allocated (for ``record_stream`` when they
        ran on another CUDA stream than ``finish``)."""
        return self._step.step.side_outputs()

    def finish(self, *, with_stats: bool = False):
        """Trim and pack, run the collective, observe: (g_agg, new_state[,
        stats]), as the flat call returns them."""
        if self._done:
            raise RuntimeError("finish() called twice on one stream")
        if not self._fed:
            raise ValueError("finish() with no fed segments")
        self._done = True
        return self._gs._close(self._step.finish(), self._step.step.j,
                               self._p, with_stats)


def _worker_key(key, i: int):
    """Worker i's randk key in a round: ``fold_in(key, i)``, as the
    reference derives it (None stays None)."""
    if key is None:
        return None
    from repro_torch.core import threefry
    return threefry.fold_in(key, i)


# one-shot deprecation marker for the sync_gradient shim (tests reset it)
_shim_warned = False


def sync_gradient(cfg: SparsifierConfig, state: dict, g: torch.Tensor,
                  group=None, participate=None, with_stats: bool = False):
    """Deprecated thin shim over :class:`GradientSync`, bit-identical to
    ``GradientSync(cfg, group)(state, g, participate=participate,
    with_stats=with_stats)``; warns ``DeprecationWarning`` once per
    process."""
    global _shim_warned
    if not _shim_warned:
        _shim_warned = True
        warnings.warn(
            "aggregate.sync_gradient is deprecated: build an "
            "aggregate.GradientSync(cfg, group) once per run and call it "
            "per step (DESIGN.md §2.8).",
            DeprecationWarning, stacklevel=2)
    return GradientSync(cfg, group)(state, g, participate=participate,
                                    with_stats=with_stats)


# -- wire-byte models (pure Python over the config) ---------------------

def comm_bytes_per_step(cfg: SparsifierConfig, j: int, n_workers: int,
                        n_active=None) -> dict:
    """Communication bytes per worker per step under the config's
    effective comm mode (the reference's model, DESIGN.md §2.5): dense
    bytes for the dense-wire baselines and the simulate combine, the
    sketch all-reduce plus k values for sketch selection, n * k
    (value, index) pairs otherwise. ``n_active`` (possibly fractional)
    models an elastic wire on which absent workers send nothing; the
    ratio's denominator stays the full-fleet dense all-reduce. A config
    outside the port raises, naming its ROADMAP item."""
    check_supported(cfg)
    k = sparsify.resolve_k(cfg, j)
    dense_ar = 2 * j * 4 * (n_workers - 1) / n_workers   # ring, fp32
    na = n_workers if n_active is None else min(float(n_active),
                                                float(n_workers))
    extra = {} if n_active is None else {"n_active": na}
    eff = dispatch.effective_comm_mode(cfg)
    if sparsify.selection(cfg) == "none" or eff in ("dense", "simulate"):
        b = dense_ar if na <= 1 else 2 * j * 4 * (na - 1) / na
        return {"bytes": b, "k": k, "ratio": b / dense_ar,
                "effective_comm_mode": eff, "allocation": cfg.allocation,
                **extra}
    if sparsify.selection(cfg) == "sketch":
        sk = sketch_allreduce_bytes(cfg, j, n_workers)
        vb = _wire_value_bytes(cfg)
        b = sk + na * k * vb
        return {"bytes": b, "k": k, "ratio": b / dense_ar,
                "sketch_bytes": sk, "wire_value_bytes": vb,
                "effective_comm_mode": eff, "allocation": cfg.allocation,
                **extra}
    kp = dispatch.packed_len(cfg, j)
    vb = _wire_value_bytes(cfg)
    sparse = na * kp * (vb + 4)          # all-gathered values + indices
    return {"bytes": sparse, "k": k, "packed_len": kp,
            "wire_value_bytes": vb, "ratio": sparse / dense_ar,
            "effective_comm_mode": eff, "allocation": cfg.allocation,
            **extra}


def _wire_value_bytes(cfg: SparsifierConfig) -> int:
    """Wire bytes of one packed value (indices stay 4-byte)."""
    return getattr(torch, cfg.wire_dtype).itemsize


def sparse_gather_wire_bytes(cfg: SparsifierConfig, j: int,
                             n_workers: int, n_active=None):
    """Per-device bytes of the sparse all-gather, or None where the
    effective comm mode is not sparse: values and indices for local
    selection, values only under the sketch's shared mask."""
    check_supported(cfg)
    if dispatch.effective_comm_mode(cfg) != "sparse":
        return None
    na = n_workers if n_active is None else min(float(n_active),
                                                float(n_workers))
    pair_bytes = _wire_value_bytes(cfg)
    if dispatch.wire(cfg) != "values":
        pair_bytes += 4                  # the uint32 index rides along
    return na * dispatch.packed_len(cfg, j) * pair_bytes


def sketch_allreduce_bytes(cfg: SparsifierConfig, j: int, n_workers: int):
    """Per-device bytes of the sketch all-reduce (a ring all-reduce of the
    (rows, width) fp32 sketch), or None for other selections; absent
    workers' ring slots still move, so no n_active discount applies."""
    check_supported(cfg)
    if sparsify.selection(cfg) != "sketch":
        return None
    k = sparsify.resolve_k(cfg, j)
    width = sketch.resolve_width(k, cfg.sketch_width)
    return 2 * cfg.sketch_rows * width * 4 * (n_workers - 1) / n_workers
