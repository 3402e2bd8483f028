"""Gradient aggregation over the data-parallel process group (the port
of ``repro.core.aggregate``).

Three communication modes, as in the reference:

- ``dense``: the dense all-reduce of the raw gradient
  (``dense_allreduce``, the reference's ``pmean``): dense SGD (kind
  none) and the genie (kind globaltopk, whose top-k is taken of the
  aggregate) run it whatever mode was asked; a local or sketch selection
  asked for ``dense`` runs the simulate combine, as in the reference.
- ``sparse`` (local selection, kind topk/dgc/regtopk): every rank
  all-gathers the k (value, index) pairs of every rank and scatter-adds
  them locally, one ``index_add_`` per rank in rank order, then scales
  by 1/n. Within a rank the k indices are distinct, so each
  ``index_add_`` is deterministic on the card too, and the rank-order
  sums reproduce the reference's: g_agg is identical on every rank,
  which REGTOP-k's posterior assumes. Comm per step is n*k*8 bytes.
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
n*k*4 bytes), the error feedback closing by zeroing the shared indices
of a; in simulate mode the dense masked ghat is all-reduced instead.
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
``n_active`` and ``dropped_nonfinite``. Sketch selection under a mask
is not ported yet (ROADMAP A12).

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

import functools
import operator
import warnings
from collections import Counter

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.configs.base import SparsifierConfig
from repro_torch.core import bigvec, select, sketch, sparsify
from repro_torch.core.numerics import fma_f32
from repro_torch.kernels.compress import dispatch
from repro_torch.kernels.fused_ef.ops import fused_apply_mask

# (kind, selector, pipeline) combos already warned about: the sparse ->
# simulate degrade is surfaced once per config per process
_DEGRADE_WARNED: set = set()
COMBINES = ("mean", "support")
_SKETCH_ELASTIC = ("elastic participation with sketch selection is not "
                   "ported yet (ROADMAP A10 with A12: the elastic sketch "
                   "semantics)")


def world(group=None) -> tuple[int, int]:
    """(size, rank) of the group, (1, 0) when torch.distributed is off."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def check_supported(cfg: SparsifierConfig) -> None:
    """The sync paths the port serves; anything else raises
    NotImplementedError naming its ROADMAP item."""
    sparsify.check_supported(cfg)
    if cfg.combine not in COMBINES:
        raise ValueError(f"unknown combine={cfg.combine!r} "
                         f"(expected one of {COMBINES})")
    if sparsify.selection(cfg) == "sketch" and (cfg.combine != "mean"
                                                or cfg.err_decay != 1.0):
        raise NotImplementedError(
            f"combine={cfg.combine!r}, err_decay={cfg.err_decay!r} with "
            f"kind='sketchtopk': {_SKETCH_ELASTIC}")
    for field, served, item in (
            ("comm_mode", ("sparse", "simulate", "dense"), "A5"),
            ("wire_dtype", ("float32",), "A8 (bf16 wire)")):
        if getattr(cfg, field) not in served:
            raise NotImplementedError(
                f"SparsifierConfig.{field}={getattr(cfg, field)!r} is not "
                f"ported yet; the port serves {served!r} (ROADMAP {item})")


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


def _gather(x: torch.Tensor, group) -> list:
    n, _ = world(group)
    if n == 1:
        return [x]
    out = [torch.empty_like(x) for _ in range(n)]
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
                             count=None, combine: str = "mean"
                             ) -> torch.Tensor:
    """g_agg = (1/n) sum_ranks scatter(values_r, indices_r), rank-identical.

    Elastic (``participate`` this rank's 0-d bool bit, ``count`` its live
    packed prefix, None = all k; or ``combine="support"``): one more
    all-gather of each rank's (liveness, live count); a rank's slots
    past its count, or all of them when it sits out, go to the sentinel
    j and drop; the sum is divided by the active count, or per
    coordinate by the number of active ranks that selected it
    (``support``; coordinates nobody selected stay 0)."""
    n, _ = world(group)
    if participate is None and combine == "mean":
        dense = torch.zeros(j, dtype=values.dtype, device=values.device)
        for v, i in zip(_gather(values, group), _gather(indices, group)):
            bigvec.scatter_add_(dense, i, v)
        return _mean_scale_(dense, n)
    dev, k = values.device, values.numel()
    p = (torch.ones((), dtype=torch.bool, device=dev) if participate is None
         else participate.reshape(()))
    cnt = torch.full((), k, dtype=torch.int64, device=dev) if count is None \
        else count.reshape(()).to(torch.int64)
    meta = torch.stack([p.to(torch.int64), torch.where(p, cnt, 0)])
    pos = torch.arange(k, device=dev)
    dense = torch.zeros(j + 1, dtype=values.dtype, device=dev)
    counts = (torch.zeros(j + 1, dtype=torch.float32, device=dev)
              if combine == "support" else None)
    metas = _gather(meta, group)
    for v, i, m in zip(_gather(values, group), _gather(indices, group),
                       metas):
        il = bigvec.live_idx(i, (m[0] > 0) & (pos < m[1]), j)
        dense.index_add_(0, il, v)
        if counts is not None:
            counts.index_add_(0, il, torch.ones_like(v))
    dense = dense[:j]
    if counts is not None:
        counts = counts[:j]
        return torch.where(counts > 0, dense / counts.clamp(min=1.0), 0.0)
    n_active = _rank_sum([m[0].to(torch.float32) for m in metas])
    return dense.div_(n_active.clamp(min=1.0))


def shared_mask_allgather_combine(values: torch.Tensor, indices: torch.Tensor,
                                  j: int, group=None) -> torch.Tensor:
    """g_agg under a shared mask: every rank holds the same ``indices``,
    so only the (k,) values are all-gathered; they are summed in rank
    order, scattered once into zeros and divided by n."""
    n, _ = world(group)
    dense = torch.zeros(j, dtype=values.dtype, device=values.device)
    bigvec.scatter_add_(dense, indices, _rank_sum(_gather(values, group)))
    return _mean_scale_(dense, n)


def _guard(p: torch.Tensor, payload: torch.Tensor):
    """(p_eff, dropped): the participation bit with a non-finite payload
    dropped, and 1.0 where the guard dropped a participant (0-d)."""
    finite = torch.isfinite(payload).all()
    return p & finite, (p & ~finite).to(torch.float32)


class GradientSync:
    """Per-run gradient-sync surface: the config is validated once here,
    each step calls the object with the state and the flat gradient.
    ``fallbacks`` counts the compress calls whose trim took the exact
    dense fallback, ``fallback_reasons`` counts them by reason.

    ``comm`` is the communication mode the sync realizes
    (``dispatch.effective_comm_mode``).

    The sketch-coordinated step is three calls, so a caller can feed one
    sketch to two devices: :meth:`encode`, :meth:`allreduce_sketch` and
    :meth:`decode_exchange`. ``sketch_tables`` keeps the encode kernels'
    start table of each shape on the card (built at the first step, 142
    MB at StableLM-3B's J; either pipeline's) for as long as the sync
    lives."""

    def __init__(self, cfg: SparsifierConfig, group=None):
        check_supported(cfg)
        self.cfg = cfg
        self.group = group
        self.selection = sparsify.selection(cfg)
        self.comm = dispatch.effective_comm_mode(cfg)
        self.fallbacks = 0
        self.fallback_reasons: Counter = Counter()
        self.sketch_tables: dict = {}

    def _count(self, outs) -> None:
        for out in outs:
            if out.fallback:
                self.fallbacks += 1
                self.fallback_reasons[out.fallback] += 1

    def check_participation(self, participate) -> None:
        """Raise for a participation mask (or schedule) on a path that
        does not serve one yet."""
        if participate is not None and self.selection == "sketch":
            raise NotImplementedError(
                f"a participation mask with kind='sketchtopk': "
                f"{_SKETCH_ELASTIC}")

    def __call__(self, state: dict, g: torch.Tensor, participate=None,
                 donate: bool = False, with_stats: bool = False):
        """One flat-gradient sync step: returns (g_agg, new_state), and
        with ``with_stats`` also {"n_active", "dropped_nonfinite"} (0-d
        fp32, rank-identical). ``participate`` is this rank's 0-d bool
        participation bit (None: always in). ``donate=True`` hands the
        old state to the compressor, which frees its J-vectors as soon
        as it has read them (the caller must not use ``state`` again)."""
        self.check_participation(participate)
        n, _ = world(self.group)
        if self.selection in ("none", "global"):
            p = None if participate is None else participate.reshape(())
            g_agg = self._sync_dense(g, p)
            new = {"step": state["step"] + 1}
            if not with_stats:
                return g_agg, new
            zero = None if p is None else torch.zeros((), device=g.device)
            return g_agg, new, self._stats(p, zero, g_agg)
        if self.selection == "sketch":
            a, sk = self.encode(state, g)
            g_agg, new, _ = self.decode_exchange(self.allreduce_sketch(sk),
                                                 a, state)
            return (g_agg, new, self._stats(None, None, g_agg)) \
                if with_stats else (g_agg, new)
        j = g.numel()
        p = None if participate is None else participate.reshape(())
        out = sparsify.compress(self.cfg, state, g, omega=1.0 / n,
                                donate=donate, participate=p)
        self._count([out])
        p_eff = dropped = None
        if p is not None and out.values is not None:
            # the non-finite guard: a worker whose packed values went
            # NaN or Inf is dropped for the step (its error feedback has
            # been updated as a participant's: a one-step posterior skew)
            p_eff, dropped = _guard(p, out.values)
        elastic = p is not None or self.cfg.combine != "mean"
        if self.comm == "sparse":
            with record_function("sync/combine"):
                g_agg = sparse_allgather_combine(
                    out.values, out.indices, j, self.group,
                    participate=p_eff, count=out.count,
                    combine=self.cfg.combine) if elastic else \
                    sparse_allgather_combine(out.values, out.indices, j,
                                             self.group)
        else:
            if self.cfg.comm_mode == "sparse":
                _warn_sparse_degrade(self.cfg)
            with record_function("sync/simulate"):
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
        elastic mean under a mask); the genie then keeps the top-k of the
        aggregate, as mask * a_agg (a multiply, so an unselected
        negative entry is -0.0, as in the reference)."""
        gf = g.float()
        with record_function("sync/dense"):
            agg = (dense_allreduce(gf, self.group) if p is None
                   else _active_mean(gf, p, self.group))
        if self.selection == "none":
            return agg
        with record_function("sync/select"):
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

    def encode(self, state: dict, g: torch.Tensor):
        """(a, sketch of a) with a = err + g: one pass through
        ``sweep1_sketch`` on the fused pipeline; a plain add, then the
        ``sketch_encode`` kernel, on the reference pipeline."""
        cfg = self.cfg
        _, width = self._k_width(g.numel())
        err = state[sparsify.err_key(cfg)]
        with record_function("sketch/encode"):
            if cfg.pipeline == "fused":
                from repro_torch.kernels.compress import ops
                enc = ops.fused_sketch_encode(g.float(), err,
                                              rows=cfg.sketch_rows,
                                              width=width,
                                              tables=self.sketch_tables)
                return enc["a"], enc["sketch"]
            a = err + g.float()
            return a, sketch.encode(a, cfg.sketch_rows, width,
                                    self.sketch_tables)

    def allreduce_sketch(self, sk: torch.Tensor) -> torch.Tensor:
        """The pre-selection collective: the mean of the ranks' sketches
        (in place on ``sk``)."""
        n, _ = world(self.group)
        with record_function("sketch/allreduce"):
            if n > 1:
                dist.all_reduce(sk, op=dist.ReduceOp.SUM, group=self.group)
            return _mean_scale_(sk, n)

    def decode(self, sk_agg: torch.Tensor, j: int) -> torch.Tensor:
        """The shared top-k indices (int64, lax.top_k order) of the
        magnitude estimates decoded from the mean sketch."""
        k, _ = self._k_width(j)
        with record_function("sketch/estimate"):
            gmag = sketch.estimate(sk_agg, j)
        with record_function("sketch/select"):
            return select.topk_indices(gmag, k)

    def decode_exchange(self, sk_agg: torch.Tensor, a: torch.Tensor,
                        state: dict):
        """Decode the shared selection from the mean sketch and combine.
        Sparse comm: exchange the k selected values of a and close the
        error feedback in O(k) (a with the shared indices zeroed, in
        place). Simulate comm: the shared mask through ``topk_mask``,
        ghat and the error state through the apply kernel, and the dense
        all-reduce. Returns (g_agg, new_state, the shared indices or,
        in simulate mode, the shared mask)."""
        j = a.numel()
        key = sparsify.err_key(self.cfg)
        if self.comm == "sparse":
            idx = self.decode(sk_agg, j)
            with record_function("sync/combine"):
                g_agg = shared_mask_allgather_combine(a[idx], idx, j,
                                                      self.group)
                err = bigvec.scatter_set_(a, idx, 0.0)
            return g_agg, {key: err, "step": state["step"] + 1}, idx
        k, _ = self._k_width(j)
        with record_function("sketch/estimate"):
            gmag = sketch.estimate(sk_agg, j)
        with record_function("sketch/select"):
            mask = select.topk_mask(gmag, k, self.cfg.selector)
        del gmag
        with record_function("sync/simulate"):
            ghat, err = fused_apply_mask(a, mask)
            g_agg = simulate_allreduce(ghat, self.group)
        return g_agg, {key: err, "step": state["step"] + 1}, mask

    # -- in-process simulation ------------------------------------------

    def round(self, states: list, grads: list, omegas=None,
              participate=None):
        """One aggregation round over N in-process workers (the
        reference's ``GradientSync.round``): returns (g_agg, new_states).
        ``participate``: one bit per worker (bools or 0-d bool tensors);
        then the combine is the elastic one of the per-step path, over
        equal weights 1/n (``omegas`` is not used)."""
        self.check_participation(participate)
        if self.selection == "sketch":
            return self._round_sketch(states, grads, omegas)
        if self.selection == "global":
            return self._round_global(states, grads, omegas, participate)
        if participate is not None:
            return self._round_elastic(states, grads, participate)
        n = len(grads)
        omegas = omegas or [1.0 / n] * n
        j = grads[0].numel()
        outs = [sparsify.compress(self.cfg, s, g, omega=w)
                for s, g, w in zip(states, grads, omegas)]
        self._count(outs)
        # rank order without a leading zero, as the compiled reference
        # sums (its ``0 +`` is dropped, which keeps the sign of -0.0)
        g_agg = _weighted_sum(omegas, [sparsify.dense_ghat(o, j)
                                       for o in outs])
        return g_agg, [sparsify.observe_aggregate(self.cfg, o.state, g_agg)
                       for o in outs]

    def _round_elastic(self, states: list, grads: list, participate: list):
        """round() under a participation mask (the reference's
        ``_round_elastic``): inert payloads from sitting-out workers, the
        sum over workers divided by n_active ("mean") or per coordinate
        by the selection counts ("support"). An all-absent round gives
        g_agg = 0, and every state decays."""
        n = len(grads)
        j = grads[0].numel()
        dev = grads[0].device
        pfs = [torch.as_tensor(p, dtype=torch.bool).to(dev).reshape(())
               for p in participate]
        outs = [sparsify.compress(self.cfg, s, g, omega=1.0 / n,
                                  participate=p)
                for s, g, p in zip(states, grads, pfs)]
        self._count(outs)
        dense = _rank_sum([sparsify.dense_ghat(o, j) for o in outs])
        if self.cfg.combine == "support":
            counts = _rank_sum([sparsify.dense_mask(o, j) for o in outs])
            g_agg = torch.where(counts > 0, dense / counts.clamp(min=1.0),
                                0.0)
        else:
            n_active = _rank_sum([p.to(torch.float32) for p in pfs])
            g_agg = dense / n_active.clamp(min=1.0)
        return g_agg, [sparsify.observe_aggregate(self.cfg, o.state, g_agg,
                                                  participate=p)
                       for o, p in zip(outs, pfs)]

    def _round_sketch(self, states, grads, omegas):
        """Per-worker encode, one sketch combine, one shared mask, each
        worker's error feedback closed at that mask (dense form, as the
        reference's ``_round_sketch``)."""
        encs = [self.encode(s, g) for s, g in zip(states, grads)]
        sk_agg = self.mean_sketch([sk for _, sk in encs], omegas)
        g_agg, new, _ = self.close_sketch_round(states, [a for a, _ in encs],
                                                sk_agg, omegas)
        return g_agg, new

    @staticmethod
    def mean_sketch(sketches: list, omegas=None) -> torch.Tensor:
        """The in-process round's combine of the workers' sketches: their
        mean (the rank-order sum scaled by 1/n), or their omega-weighted
        sum."""
        if omegas is None:
            return _rank_sum(sketches) * (1.0 / len(sketches))
        return _weighted_sum(omegas, sketches)

    def close_sketch_round(self, states: list, a_list: list,
                           sk_agg: torch.Tensor, omegas=None):
        """The rest of a sketch round from the combined sketch: the shared
        top-k, every worker's ghat and error through the apply kernel, and
        g_agg; returns (g_agg, new_states, the shared indices). A caller
        may hand two devices the same ``sk_agg``."""
        j = a_list[0].numel()
        idx = self.decode(sk_agg, j)
        mask = bigvec.mask_from_indices(j, idx)
        applied = [fused_apply_mask(a, mask) for a in a_list]
        ghats = [gh for gh, _ in applied]
        g_agg = (_rank_sum(ghats) * (1.0 / len(ghats)) if omegas is None
                 else _weighted_sum(omegas, ghats))
        key = sparsify.err_key(self.cfg)
        return g_agg, [{key: err, "step": st["step"] + 1}
                       for (_, err), st in zip(applied, states)], idx

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
            dev = gfs[0].device
            pfs = [torch.as_tensor(p, dtype=torch.bool).to(dev).reshape(())
                   for p in participate]
            na = _rank_sum([p.to(torch.float32) for p in pfs])
            a_agg = _rank_sum([torch.where(p, gf, 0.0)
                               for p, gf in zip(pfs, gfs)])
            a_agg = a_agg / na.clamp(min=1.0)
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

        def round_fn(states: dict, grads: torch.Tensor):
            n, j = grads.shape
            outs = [sparsify.compress(self.cfg, st, g, omega=omega)
                    for st, g in zip(sparsify.unstack_states(states, n),
                                     grads)]
            self._count(outs)
            total = torch.zeros(j, dtype=torch.float32, device=grads.device)
            for out in outs:
                total = total + sparsify.dense_ghat(out, j)
            g_agg = total * omega
            return g_agg, sparsify.stack_states(
                [sparsify.observe_aggregate(self.cfg, o.state, g_agg)
                 for o in outs])
        return round_fn


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
