"""What a config's compress step emits and which wire its sync realizes
(the port's copy of the parts of ``repro.kernels.compress.dispatch``
that the slice serves)."""
from __future__ import annotations

from repro_torch.configs.base import SparsifierConfig
from repro_torch.core import sparsify


def packs_pairs(cfg: SparsifierConfig) -> bool:
    """compress emits exactly k packed (value, index) pairs: the fused
    pipeline, the exact selector, and REGTOP-k's O(k) layout (whose
    top-k is exact whatever the selector). The histogram selectors of the
    reference pipeline select a data-dependent count and pack nothing."""
    return (cfg.pipeline == "fused" or cfg.selector == "exact"
            or (cfg.kind == "regtopk" and cfg.state_format == "sparse"))


def effective_comm_mode(cfg: SparsifierConfig) -> str:
    """The communication mode the sync realizes: comm_mode="sparse"
    needs packed pairs, so a config without them degrades to the
    simulate all-reduce (``core.aggregate`` warns once). Sketch
    coordination ships values under the shared mask, sparse on both
    pipelines."""
    if cfg.comm_mode != "sparse":
        return cfg.comm_mode
    if sparsify.selection(cfg) == "sketch" or packs_pairs(cfg):
        return "sparse"
    return "simulate"

