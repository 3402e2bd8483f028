"""Gradient sparsifiers: TOP-k and REGTOP-k (the paper, Algorithm 1) on the
fused two-sweep pipeline, and the state of sketch-coordinated TOP-k (the
port of ``repro.core.sparsify``).

Protocol per step (worker n), as in the reference:

    out = compress(cfg, state, g, omega)          # local selection
    g_agg = combine(out.values, out.indices)      # core/aggregate.py
    state = observe_aggregate(cfg, out.state, g_agg)

The fused layout's only J-sized state is ``err_prev`` (= a^{t-1} *
(1 - s^{t-1})). REGTOP-k's posterior is O(k): ``idx_prev`` (int32 view of
the uint32 indices, doubling as the support set), ``a_prev_sel`` and
``g_prev_sel``. kind="sketchtopk" selects at the aggregate level
(``core.aggregate.GradientSync``), so ``compress`` raises for it; its
state is ``err_prev`` (fused) or ``err`` (reference pipeline) and
``step``.
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


# (field, values the port serves, ROADMAP item that ports the rest)
_COMMON = (("selector", ("exact",), "A8 (histogram selector)"),
           ("num_buckets", (1,), "A8 (bucketed sweeps)"),
           ("allocation", ("global",), "A9 (density allocation)"),
           ("overlap", ("none",), "A11 (streaming overlap)"),
           ("ef_dtype", ("float32",), "A8 (bf16 EF state)"))
_PIPELINE = "A3 (reference pipeline)"
_LOCAL = (("pipeline", ("fused",), _PIPELINE),) + _COMMON
# per kind: (where its top-k is decided, the fields it is served at)
_SLICE = {"topk": ("local", _LOCAL),
          "regtopk": ("local", _LOCAL),
          "sketchtopk": ("sketch", (("pipeline", ("fused", "reference"),
                                     _PIPELINE),) + _COMMON)}
_UNPORTED_KINDS = {"dgc": "A8", "randk": "A8", "thresholdk": "A8",
                   "none": "A5", "globaltopk": "A5"}


def check_supported(cfg: SparsifierConfig) -> None:
    """Raise NotImplementedError naming the ROADMAP item for a config
    outside the ported slice (never a silent reroute)."""
    if cfg.kind not in _SLICE:
        item = _UNPORTED_KINDS.get(cfg.kind, "A8")
        raise NotImplementedError(
            f"SparsifierConfig.kind={cfg.kind!r} is not ported yet; the "
            f"port serves {tuple(_SLICE)} (ROADMAP {item})")
    for field, served, item in _SLICE[cfg.kind][1]:
        val = getattr(cfg, field)
        if val not in served:
            raise NotImplementedError(
                f"SparsifierConfig.{field}={val!r} is not ported yet for "
                f"kind={cfg.kind!r}; the port serves {served} "
                f"(ROADMAP {item})")


def selection(cfg: SparsifierConfig) -> str:
    """Where the config's top-k is decided: "local" (each worker selects
    and ships (value, index) pairs) or "sketch" (one shared mask decoded
    from the all-reduced CountSketch; values travel alone)."""
    check_supported(cfg)
    return _SLICE[cfg.kind][0]


def err_key(cfg: SparsifierConfig) -> str:
    """The error-feedback state's key: "err_prev" on the fused pipeline,
    "err" on the reference pipeline (as in the reference's layouts)."""
    return "err_prev" if cfg.pipeline == "fused" else "err"


def resolve_k(cfg: SparsifierConfig, j: int) -> int:
    if cfg.k:
        return int(min(cfg.k, j))
    return max(1, int(round(cfg.sparsity * j)))


def init_state(cfg: SparsifierConfig, j: int, device) -> dict:
    """Zero state for a J-length flat gradient."""
    check_supported(cfg)
    st = {err_key(cfg): torch.zeros(j, dtype=torch.float32, device=device),
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
    if selection(cfg) == "sketch":
        raise RuntimeError("sketchtopk selection is aggregate-level; run "
                           "it through aggregate.GradientSync (call or "
                           "round)")
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
