"""Gradient aggregation over the data-parallel process group (the port
of ``repro.core.aggregate``).

Two communication modes, as in the reference:

- ``sparse`` (local selection, kind topk/dgc/regtopk): every rank
  all-gathers the k (value, index) pairs of every rank and scatter-adds
  them locally, one ``index_add_`` per rank in rank order, then divides
  by n. Within a rank the k indices are distinct, so each ``index_add_``
  is deterministic on the card too, and the rank-order sums reproduce
  the reference's: g_agg is identical on every rank, which REGTOP-k's
  posterior assumes. Comm per step is n*k*8 bytes.
- ``simulate``: every rank all-reduces its dense sparsified gradient
  ghat (a SUM, then a division by n: the reference's ``pmean``). Exact
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
combine all-reduces where(p, ghat, 0), and the normaliser is the active
count n_active (``combine="mean"``) or, per coordinate, the number of
active workers that selected it (``combine="support"``). A worker whose
packed values (or dense ghat) are not finite is dropped for the step
(the non-finite guard); ``with_stats`` reports ``n_active`` and
``dropped_nonfinite``. Sketch selection under a mask is not ported yet
(ROADMAP A12).

Divisions by a worker count divide by a tensor on the card: torch turns
a division by a host scalar into a multiply by its reciprocal there,
which differs from the reference's division at counts that are not a
power of two.

Without an initialised process group the world is one rank; the same code
runs and gathers nothing.
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
            ("comm_mode", ("sparse", "simulate"),
             "A5 (dense all-reduce)"),
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


def _n(n: int, like: torch.Tensor) -> torch.Tensor:
    """The worker count n as a 0-d tensor on like's device, so that a
    division by it is a true division on the card too."""
    return torch.full((), n, dtype=like.dtype, device=like.device)


def _gather(x: torch.Tensor, group) -> list:
    n, _ = world(group)
    if n == 1:
        return [x]
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    return out


def simulate_allreduce(ghat: torch.Tensor, group=None) -> torch.Tensor:
    """g_agg = (1/n) sum_ranks ghat_r: a SUM all-reduce, then a division
    by n (the reference's ``pmean``), in place on ``ghat``; over one rank
    the identity."""
    n, _ = world(group)
    if n == 1:
        return ghat
    dist.all_reduce(ghat, op=dist.ReduceOp.SUM, group=group)
    return ghat.div_(_n(n, ghat))


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
        return dense.div_(_n(n, dense))
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
    return dense.div_(_n(n, dense))


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

    def _simulate_elastic(self, out, ghat, p_eff, j: int) -> torch.Tensor:
        """The simulate combine under participation or the support
        rule: the SUM all-reduce of where(p, ghat, 0), divided by the
        active count or by each coordinate's active selection count."""
        pe = (torch.ones((), dtype=torch.bool, device=ghat.device)
              if p_eff is None else p_eff)
        n, _ = world(self.group)
        dsum = torch.where(pe, ghat, 0.0)
        if self.cfg.combine == "support":
            cnts = torch.where(pe, sparsify.dense_mask(out, j), 0.0)
            if n > 1:
                dist.all_reduce(dsum, group=self.group)
                dist.all_reduce(cnts, group=self.group)
            return torch.where(cnts > 0, dsum / cnts.clamp(min=1.0), 0.0)
        na = pe.to(ghat.dtype)
        if n > 1:
            dist.all_reduce(dsum, group=self.group)
            dist.all_reduce(na, group=self.group)
        return dsum / na.clamp(min=1.0)

    def _stats(self, p_eff, dropped, like) -> dict:
        """{"n_active", "dropped_nonfinite"}: the sums over ranks of the
        effective participation bits and of the guard's drops (the world
        size and 0 without a mask)."""
        n, _ = world(self.group)
        if p_eff is None:
            return {"n_active": _n(n, like).float(),
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
            return sk.div_(_n(n, sk))

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
        g_agg = _rank_sum([w * sparsify.dense_ghat(o, j)
                           for w, o in zip(omegas, outs)])
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
        n = len(grads)
        j = grads[0].numel()
        encs = [self.encode(s, g) for s, g in zip(states, grads)]
        if omegas is None:
            sk_agg = _rank_sum([sk for _, sk in encs]) / _n(n, encs[0][1])
        else:
            sk_agg = _rank_sum([w * sk for w, (_, sk) in zip(omegas, encs)])
        idx = self.decode(sk_agg, j)
        mask = bigvec.mask_from_indices(j, idx)
        applied = [fused_apply_mask(a, mask) for a, _ in encs]
        ghats = [gh for gh, _ in applied]
        if omegas is None:
            g_agg = _rank_sum(ghats) / _n(n, ghats[0])
        else:
            g_agg = _rank_sum([w * gh for w, gh in zip(omegas, ghats)])
        key = sparsify.err_key(self.cfg)
        return g_agg, [{key: err, "step": st["step"] + 1}
                       for (_, err), st in zip(applied, states)]
