"""Gradient sparsifiers: TOP-k and REGTOP-k (the paper, Algorithm 1) on the
fused two-sweep pipeline (the port of ``repro.core.sparsify``).

Protocol per step (worker n), as in the reference:

    out = compress(cfg, state, g, omega)          # local selection
    g_agg = combine(out.values, out.indices)      # core/aggregate.py
    state = observe_aggregate(cfg, out.state, g_agg)

The fused layout's only J-sized state is ``err_prev`` (= a^{t-1} *
(1 - s^{t-1})). REGTOP-k's posterior is O(k): ``idx_prev`` (int32 view of
the uint32 indices, doubling as the support set), ``a_prev_sel`` and
``g_prev_sel``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import SparsifierConfig
from repro_torch.core import bigvec


@dataclass
class CompressOut:
    state: dict                  # updated state (pre-aggregation)
    values: torch.Tensor         # (k,) fp32 packed values, |score| desc
    indices: torch.Tensor        # (k,) int32 view of uint32 indices
    fallback: str = ""           # why the trim took the exact dense
                                 # fallback ("" = fast path, ops.py)


# (field, value the port serves, ROADMAP item that ports the rest)
_SLICE = (("pipeline", ("fused",), "A3 (reference pipeline)"),
          ("kind", ("topk", "regtopk"), "A8 (dgc, randk, thresholdk), "
           "A12 (sketchtopk), A5 (none, globaltopk)"),
          ("selector", ("exact",), "A8 (histogram selector)"),
          ("num_buckets", (1,), "A8 (bucketed sweeps)"),
          ("allocation", ("global",), "A9 (density allocation)"),
          ("overlap", ("none",), "A11 (streaming overlap)"),
          ("ef_dtype", ("float32",), "A8 (bf16 EF state)"))


def check_supported(cfg: SparsifierConfig) -> None:
    """Raise NotImplementedError naming the ROADMAP item for a config
    outside the ported slice (never a silent reroute)."""
    for field, served, item in _SLICE:
        val = getattr(cfg, field)
        if val not in served:
            raise NotImplementedError(
                f"SparsifierConfig.{field}={val!r} is not ported yet; the "
                f"port serves {served} (ROADMAP {item})")


def resolve_k(cfg: SparsifierConfig, j: int) -> int:
    if cfg.k:
        return int(min(cfg.k, j))
    return max(1, int(round(cfg.sparsity * j)))


def init_state(cfg: SparsifierConfig, j: int, device) -> dict:
    """Zero state of the fused layout for a J-length flat gradient."""
    check_supported(cfg)
    st = {"err_prev": torch.zeros(j, dtype=torch.float32, device=device),
          "step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.kind == "regtopk":
        k = resolve_k(cfg, j)
        st["idx_prev"] = torch.zeros(k, dtype=torch.int32, device=device)
        st["a_prev_sel"] = torch.zeros(k, dtype=torch.float32, device=device)
        st["g_prev_sel"] = torch.zeros(k, dtype=torch.float32, device=device)
    return st


def compress(cfg: SparsifierConfig, state: dict, g: torch.Tensor,
             omega: float = 1.0) -> CompressOut:
    """Sparsify one worker's flat fp32 gradient; omega = its weight w_n.
    ``state`` is only read; the new state holds new buffers."""
    from repro_torch.kernels.compress import ops
    check_supported(cfg)
    j = g.numel()
    k = resolve_k(cfg, j)
    kwargs = {}
    if cfg.kind == "regtopk":
        kwargs = dict(idx_prev=state["idx_prev"],
                      a_prev_sel=state["a_prev_sel"],
                      g_prev_sel=state["g_prev_sel"])
    out = ops.fused_compress_arrays(
        cfg.kind, g.float(), state["err_prev"], state["step"], k=k,
        omega=omega, mu=cfg.mu, Q=cfg.Q, **kwargs)
    new = {"err_prev": out["err"], "step": state["step"] + 1}
    if cfg.kind == "regtopk":
        new["idx_prev"] = out["indices"]
        new["a_prev_sel"] = out["values"]
        new["g_prev_sel"] = torch.zeros_like(state["g_prev_sel"])
    return CompressOut(new, out["values"], out["indices"], out["fallback"])


def observe_aggregate(cfg: SparsifierConfig, state: dict,
                      g_agg: torch.Tensor) -> dict:
    """Store the aggregated gradient at the support (REGTOP-k only, O(k)).
    g_agg must be rank-identical (the sparse combine guarantees it)."""
    if cfg.kind != "regtopk":
        return state
    return dict(state, g_prev_sel=bigvec.gather(g_agg, state["idx_prev"]))


def dense_ghat(out: CompressOut, j: int) -> torch.Tensor:
    """Dense sparsified gradient rebuilt from the packed pairs."""
    ghat = torch.zeros(j, dtype=out.values.dtype, device=out.values.device)
    return bigvec.scatter_add_(ghat, out.indices, out.values)
