"""Sparse gradient aggregation over the data-parallel process group (the
port of ``repro.core.aggregate``, non-elastic sparse mean path).

Every rank all-gathers the k (value, index) pairs of every rank and
scatter-adds them locally, one ``index_add_`` per rank in rank order, then
divides by n. Within a rank the k indices are distinct, so each
``index_add_`` is deterministic on the card too, and the rank-order sums
reproduce the reference's: g_agg is identical on every rank, which
REGTOP-k's posterior assumes. Comm per step is n*k*8 bytes.

Without an initialised process group the world is one rank; the same code
runs and gathers nothing.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.configs.base import SparsifierConfig
from repro_torch.core import bigvec, sparsify


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
            ("comm_mode", "sparse", "A5 (simulate and dense all-reduce)"),
            ("combine", "mean", "A10 (support combine)"),
            ("wire_dtype", "float32", "A8 (bf16 wire)")):
        if getattr(cfg, field) != served:
            raise NotImplementedError(
                f"SparsifierConfig.{field}={getattr(cfg, field)!r} is not "
                f"ported yet; the port serves {served!r} (ROADMAP {item})")


def sparse_allgather_combine(values: torch.Tensor, indices: torch.Tensor,
                             j: int, group=None) -> torch.Tensor:
    """g_agg = (1/n) sum_ranks scatter(values_r, indices_r), rank-identical."""
    n, _ = world(group)
    if n == 1:
        vals, idxs = [values], [indices]
    else:
        vals = [torch.empty_like(values) for _ in range(n)]
        idxs = [torch.empty_like(indices) for _ in range(n)]
        dist.all_gather(vals, values, group=group)
        dist.all_gather(idxs, indices, group=group)
    dense = torch.zeros(j, dtype=values.dtype, device=values.device)
    for v, i in zip(vals, idxs):
        bigvec.scatter_add_(dense, i, v)
    return dense.div_(n)


class GradientSync:
    """Per-run gradient-sync surface: the config is validated once here,
    each step calls the object with the state and the flat gradient.
    ``fallbacks`` counts the compress calls whose trim took the exact
    dense fallback, ``fallback_reasons`` counts them by reason."""

    def __init__(self, cfg: SparsifierConfig, group=None):
        check_supported(cfg)
        self.cfg = cfg
        self.group = group
        self.fallbacks = 0
        self.fallback_reasons: Counter = Counter()

    def _count(self, outs) -> None:
        for out in outs:
            if out.fallback:
                self.fallbacks += 1
                self.fallback_reasons[out.fallback] += 1

    def __call__(self, state: dict, g: torch.Tensor):
        """One flat-gradient sync step: returns (g_agg, new_state)."""
        n, _ = world(self.group)
        out = sparsify.compress(self.cfg, state, g, omega=1.0 / n)
        self._count([out])
        with record_function("sync/combine"):
            g_agg = sparse_allgather_combine(out.values, out.indices,
                                             g.numel(), self.group)
        return g_agg, sparsify.observe_aggregate(self.cfg, out.state, g_agg)

    def round(self, states: list, grads: list, omegas=None):
        """One aggregation round over N in-process workers (the
        reference's ``GradientSync.round``): returns (g_agg, new_states)."""
        n = len(grads)
        omegas = omegas or [1.0 / n] * n
        j = grads[0].numel()
        outs = [sparsify.compress(self.cfg, s, g, omega=w)
                for s, g, w in zip(states, grads, omegas)]
        self._count(outs)
        g_agg = sum(w * sparsify.dense_ghat(o, j)
                    for w, o in zip(omegas, outs))
        return g_agg, [sparsify.observe_aggregate(self.cfg, o.state, g_agg)
                       for o in outs]
