"""Gradient aggregation over the data-parallel process group (the port
of ``repro.core.aggregate``, non-elastic mean paths).

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


def world(group=None) -> tuple[int, int]:
    """(size, rank) of the group, (1, 0) when torch.distributed is off."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def check_supported(cfg: SparsifierConfig) -> None:
    """The sync paths the port serves; anything else raises
    NotImplementedError naming its ROADMAP item."""
    sparsify.check_supported(cfg)
    for field, served, item in (
            ("comm_mode", ("sparse", "simulate"),
             "A5 (dense all-reduce)"),
            ("combine", ("mean",), "A10 (support combine)"),
            ("err_decay", (1.0,), "A10 (elastic error-feedback decay)"),
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
    return ghat.div_(n)


def sparse_allgather_combine(values: torch.Tensor, indices: torch.Tensor,
                             j: int, group=None) -> torch.Tensor:
    """g_agg = (1/n) sum_ranks scatter(values_r, indices_r), rank-identical."""
    n, _ = world(group)
    dense = torch.zeros(j, dtype=values.dtype, device=values.device)
    for v, i in zip(_gather(values, group), _gather(indices, group)):
        bigvec.scatter_add_(dense, i, v)
    return dense.div_(n)


def shared_mask_allgather_combine(values: torch.Tensor, indices: torch.Tensor,
                                  j: int, group=None) -> torch.Tensor:
    """g_agg under a shared mask: every rank holds the same ``indices``,
    so only the (k,) values are all-gathered; they are summed in rank
    order, scattered once into zeros and divided by n."""
    n, _ = world(group)
    dense = torch.zeros(j, dtype=values.dtype, device=values.device)
    bigvec.scatter_add_(dense, indices, _rank_sum(_gather(values, group)))
    return dense.div_(n)


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

    @staticmethod
    def _no_participate(participate) -> None:
        if participate is not None:
            raise NotImplementedError(
                "participation masks are not ported yet (ROADMAP A10)")

    def __call__(self, state: dict, g: torch.Tensor, participate=None,
                 donate: bool = False):
        """One flat-gradient sync step: returns (g_agg, new_state).
        ``donate=True`` hands the old state to the compressor, which
        frees its J-vectors as soon as it has read them (the caller must
        not use ``state`` again)."""
        self._no_participate(participate)
        if self.selection == "sketch":
            a, sk = self.encode(state, g)
            g_agg, new, _ = self.decode_exchange(self.allreduce_sketch(sk),
                                                 a, state)
            return g_agg, new
        n, _ = world(self.group)
        j = g.numel()
        out = sparsify.compress(self.cfg, state, g, omega=1.0 / n,
                                donate=donate)
        self._count([out])
        if self.comm == "sparse":
            with record_function("sync/combine"):
                g_agg = sparse_allgather_combine(out.values, out.indices, j,
                                                 self.group)
        else:
            if self.cfg.comm_mode == "sparse":
                _warn_sparse_degrade(self.cfg)
            with record_function("sync/simulate"):
                g_agg = simulate_allreduce(sparsify.dense_ghat(out, j),
                                           self.group)
        return g_agg, sparsify.observe_aggregate(self.cfg, out.state, g_agg)

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
            return sk.div_(n)

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
        reference's ``GradientSync.round``): returns (g_agg, new_states)."""
        self._no_participate(participate)
        if self.selection == "sketch":
            return self._round_sketch(states, grads, omegas)
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

    def _round_sketch(self, states, grads, omegas):
        """Per-worker encode, one sketch combine, one shared mask, each
        worker's error feedback closed at that mask (dense form, as the
        reference's ``_round_sketch``)."""
        n = len(grads)
        j = grads[0].numel()
        encs = [self.encode(s, g) for s, g in zip(states, grads)]
        if omegas is None:
            sk_agg = _rank_sum([sk for _, sk in encs]) / n
        else:
            sk_agg = _rank_sum([w * sk for w, (_, sk) in zip(omegas, encs)])
        idx = self.decode(sk_agg, j)
        mask = bigvec.mask_from_indices(j, idx)
        applied = [fused_apply_mask(a, mask) for a, _ in encs]
        ghats = [gh for gh, _ in applied]
        if omegas is None:
            g_agg = _rank_sum(ghats) / n
        else:
            g_agg = _rank_sum([w * gh for w, gh in zip(omegas, ghats)])
        key = sparsify.err_key(self.cfg)
        return g_agg, [{key: err, "step": st["step"] + 1}
                       for (_, err), st in zip(applied, states)]
