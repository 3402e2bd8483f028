"""What a config's compress step emits and which wire its sync realizes
(the port's copy of the parts of ``repro.kernels.compress.dispatch``
that the slice serves)."""
from __future__ import annotations

from repro_torch.configs.base import SparsifierConfig
from repro_torch.core import sparsify


def packs_pairs(cfg: SparsifierConfig) -> bool:
    """compress emits exactly k packed (value, index) pairs: local
    selection on the fused pipeline, with the exact selector, or in
    REGTOP-k's O(k) layout (whose top-k is exact whatever the selector).
    The histogram selectors of the reference pipeline select a
    data-dependent count and pack nothing; nor do the sketch, the genie
    and dense SGD, which select no per-worker pairs."""
    return sparsify.selection(cfg) == "local" and (
        cfg.pipeline == "fused" or cfg.selector == "exact"
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
    per-worker unit of the sparse all-gather: k for every config the
    port serves. The fused histogram selector's fixed capacity
    (``hist_capacity``) is not served: its config raises, naming A8."""
    sparsify.check_supported(cfg)
    return sparsify.resolve_k(cfg, j)
