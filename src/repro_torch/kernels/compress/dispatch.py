"""What a config's compress step emits and which wire its sync realizes
(the port's copy of ``repro.kernels.compress.dispatch``).

The fused pipeline serves the kinds of :data:`FUSED_KINDS` and the
sketch's encode (:func:`fused_reason`; any other config runs the
reference pipeline, whatever ``cfg.pipeline`` asks, as in the
reference). Its
histogram selector (``selector="histogram"``) selects at the bit-pattern
bin edge of the k-th |score| and packs a fixed :func:`hist_capacity`
pairs, count in [k, capacity] of them live and the tail inert (value
0.0 at index 0); randk selects without a score and ignores the
selector.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import SparsifierConfig
from repro_torch.core import sparsify

# kinds of the fused two-sweep pipeline: randk is one elementwise pass
# and an O(k) random gather, thresholdk shares topk's plain-score path
FUSED_KINDS = ("topk", "dgc", "regtopk", "randk", "thresholdk")
FUSED_SELECTORS = ("exact", "histogram")
# the fused histogram selector's over-selection cap: count <= k * (1 +
# HIST_SLACK)
HIST_SLACK = 1.0


def hist_capacity(k: int, j: int) -> int:
    """Packed capacity of the fused histogram selector: min(j, k +
    ceil(k * HIST_SLACK)), never below k + 1."""
    k = int(min(k, j))
    return int(min(j, k + max(1, int(math.ceil(k * HIST_SLACK)))))


def fused_reason(cfg: SparsifierConfig) -> str:
    """Why the fused pipeline does not serve cfg ("" when it does), as
    the reference's dispatch decides it: a config that asks for
    pipeline="fused" with a kind or a selector the two sweeps do not
    implement (the genie, dense SGD, ``histogram_kernel``) runs the
    reference pipeline, with that pipeline's state layout. The sketch's
    encode folds into sweep 1 whatever the selector, which then only
    decodes the shared mask."""
    if cfg.pipeline != "fused":
        return f"pipeline={cfg.pipeline!r} requested"
    if cfg.kind == "sketchtopk":
        if cfg.selector not in FUSED_SELECTORS:
            return (f"selector={cfg.selector!r} has no shared-mask "
                    "decode on the fused sketch path")
        return ""
    if cfg.kind not in FUSED_KINDS:
        return (f"kind={cfg.kind!r} has no per-worker compress step the "
                "two-sweep pipeline can serve (aggregate-level "
                "selection)")
    if cfg.kind != "randk" and cfg.selector not in FUSED_SELECTORS:
        return (f"selector={cfg.selector!r} is served by kernels/topk_select "
                "on the reference path")
    return ""


def fused(cfg: SparsifierConfig) -> bool:
    """The fused pipeline serves cfg (:func:`fused_reason`)."""
    return not fused_reason(cfg)


def fused_histogram(cfg: SparsifierConfig) -> bool:
    """The fused pipeline's histogram selector serves the config: a fused
    kind but randk, which ignores the selector."""
    return (fused(cfg) and cfg.selector == "histogram"
            and cfg.kind in FUSED_KINDS and cfg.kind != "randk")


def packs_pairs(cfg: SparsifierConfig) -> bool:
    """compress emits fixed-size packed (value, index) pairs: local
    selection on the fused pipeline (any selector), or on the reference
    pipeline with the exact selector, with randk (selector-free) or in
    REGTOP-k's O(k) layout (whose top-k is exact whatever the selector).
    The histogram selectors of the reference pipeline select a
    data-dependent count and pack nothing; nor do the sketch, the genie
    and dense SGD, which select no per-worker pairs."""
    return sparsify.selection(cfg) == "local" and (
        fused(cfg) or cfg.selector == "exact"
        or cfg.kind == "randk"
        or (cfg.kind == "regtopk" and cfg.state_format == "sparse"))


def wire(cfg: SparsifierConfig) -> str:
    """What travels on the sparse wire: "pairs" (local selection),
    "values" (the sketch's shared mask implies the indices) or "dense"
    (the genie and dense SGD all-reduce the dense gradient)."""
    return {"local": "pairs", "sketch": "values"}.get(
        sparsify.selection(cfg), "dense")


def effective_comm_mode(cfg: SparsifierConfig) -> str:
    """The communication mode the sync realizes: comm_mode="sparse"
    needs packed pairs, so a config without them degrades to the
    simulate all-reduce (``core.aggregate`` warns once). Sketch
    coordination ships values under the shared mask, sparse on both
    pipelines; the dense-wire baselines all-reduce densely whatever was
    asked. comm_mode="dense" on a local or sketch selection runs the
    simulate combine, as in the reference."""
    if cfg.comm_mode != "sparse":
        return cfg.comm_mode
    w = wire(cfg)
    if w == "dense":
        return "dense"
    if w == "values" or packs_pairs(cfg):
        return "sparse"
    return "simulate"


def packed_len(cfg: SparsifierConfig, j: int) -> int:
    """Length of the packed (values, indices) arrays compress emits, the
    per-worker unit of the sparse all-gather: :func:`hist_capacity` for
    the fused histogram selector, k otherwise."""
    k = sparsify.resolve_k(cfg, j)
    sparsify.check_supported(cfg)
    return hist_capacity(k, j) if fused_histogram(cfg) else k


def check_overlap(cfg: SparsifierConfig) -> None:
    """Raise the reference's ValueError for an ``overlap`` the config
    cannot stream: only the fused pipeline's per-worker compress step
    takes the gradient a segment at a time; the sketch's all-reduce is a
    barrier over the whole accumulated gradient, and the reference
    pipeline's dense math does not partition."""
    overlap = getattr(cfg, "overlap", "none")
    if overlap not in ("none", "backward"):
        raise ValueError(f"overlap={overlap!r} (expected 'none' or "
                         "'backward')")
    if overlap != "backward":
        return
    if cfg.kind == "sketchtopk":
        raise ValueError(
            "overlap='backward' is not defined for sketch-coordinated "
            "selection (kind='sketchtopk'): the sketch all-reduce is a "
            "pre-selection barrier over the WHOLE accumulated gradient, "
            "so no per-segment stream can launch before the shared mask "
            "exists (DESIGN.md §2.9)")
    reason = fused_reason(cfg)
    if reason:
        raise ValueError("overlap='backward' requires the fused pipeline; "
                         f"this config dispatches to the reference path "
                         f"({reason})")
