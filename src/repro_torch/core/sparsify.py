"""Gradient sparsifiers: TOP-k, DGC and REGTOP-k (the paper, Algorithm 1)
on both pipelines, and the state of sketch-coordinated TOP-k (the port of
``repro.core.sparsify``).

Protocol per step (worker n), as in the reference:

    out = compress(cfg, state, g, omega)          # local selection
    g_agg = combine(out)                          # core/aggregate.py
    state = observe_aggregate(cfg, out.state, g_agg)

REGTOP-k (Algorithm 1):
    a^t      = eps^t + g^t
    Delta^t  = s^{t-1} * (g_agg^{t-1} - w_n a^{t-1}) / (w_n a^t)
               + Q (1 - s^{t-1})
    s^t      = Top_k( a^t * tanh(|1 + Delta^t| / mu) )
    ghat^t   = s^t * a^t,   eps^{t+1} = a^t - ghat^t
with plain TOP-k at t = 0.

DGC (Deep Gradient Compression, Lin et al. '18; momentum correction):
    mom'     = momentum * mom + g
    a^t      = eps^t + mom'
    s^t      = Top_k(a^t),   eps^{t+1} = a^t (1 - s^t),
    mom      = mom' (1 - s^t)

Pipelines (``cfg.pipeline``):

- "reference": the dense math above with ``cfg.selector`` (exact,
  histogram or histogram_kernel). REGTOP-k keeps the dense posterior
  (``state_format="dense"``: err, a_prev, s_prev, g_agg_prev J-vectors;
  score and apply through the ``kernels.fused_ef`` kernels) or the O(k)
  one (``"sparse"``: plain tensor ops, exact top-k whatever the
  selector). ``CompressOut`` carries the dense ``ghat`` and ``mask``, and
  packed (values, indices) only where the count is exactly k.
- "fused": the two-sweep pipeline (``kernels.compress.ops``), exact
  selector. The J-sized state is ``err_prev`` (= a^{t-1} *
  (1 - s^{t-1})), and DGC's ``mom``; REGTOP-k's posterior is O(k):
  ``idx_prev`` (int32 view of the uint32 indices, doubling as the
  support set), ``a_prev_sel`` and ``g_prev_sel``.

DGC's momentum is masked with a multiply on the reference pipeline and
with an O(k) scatter-zero on the fused one, as in the reference: a
selected negative momentum becomes -0.0 on the first and +0.0 on the
second.

Elastic participation (``participate``, a 0-d bool tensor: does this
worker take part in the step's sync?) applies on both pipelines: the
inputs are masked (g_eff = where(p, g, 0), err_eff = where(p, err,
err_decay * err); the fused pipeline does it inside sweep 1), a
sitting-out worker's payload is inert (mask 0, values 0, indices 0,
``count`` 0), its error decays in place, DGC's momentum still advances
to momentum * mom, and REGTOP-k's posterior keeps the t-1 quantities of
its last participating step.

kind="sketchtopk" selects at the aggregate level
(``core.aggregate.GradientSync``), so ``compress`` raises for it; its
state is ``err_prev`` (fused) or ``err`` (reference pipeline) and
``step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.configs.base import SparsifierConfig
from repro_torch.core import bigvec, select
from repro_torch.core.numerics import (fma_f32, recip_f32,
                                       regularizer_factor, safe_denom,
                                       tanh_f32)
from repro_torch.kernels.fused_ef import ops as fef


@dataclass
class CompressOut:
    state: dict                  # updated state (pre-aggregation)
    values: Optional[torch.Tensor]   # (k,) fp32 packed values, |score|
                                     # desc; None where the count is not k
    indices: Optional[torch.Tensor]  # (k,) int32 view of uint32 indices
    fallback: str = ""           # why the fused trim took the exact dense
                                 # fallback ("" = fast path, ops.py)
    ghat: Optional[torch.Tensor] = None   # dense (J,) mask * a (reference
                                          # pipeline; None when fused)
    mask: Optional[torch.Tensor] = None   # dense (J,) 0/1 selection mask
                                          # (reference pipeline)
    count: Optional[torch.Tensor] = None  # 0-d int32 live packed slots
                                          # (k, or 0 for a sitting-out
                                          # worker); None: all k live


# (field, values the port serves, ROADMAP item that ports the rest)
_COMMON = (("num_buckets", (1,), "A8 (bucketed sweeps)"),
           ("allocation", ("global",), "A9 (density allocation)"),
           ("overlap", ("none",), "A11 (streaming overlap)"),
           ("ef_dtype", ("float32",), "A8 (bf16 EF state)"))
_PIPELINES = ("fused", "reference")
# per kind: where its top-k is decided
_SLICE = {"topk": "local", "dgc": "local", "regtopk": "local",
          "sketchtopk": "sketch"}
# selectors served per (selection, pipeline); the rest raise A8
_SELECTORS = {("local", "reference"): ("exact", "histogram",
                                       "histogram_kernel")}
_UNPORTED_KINDS = {"randk": "A8", "thresholdk": "A8", "none": "A5",
                   "globaltopk": "A5"}


def check_supported(cfg: SparsifierConfig) -> None:
    """Raise NotImplementedError naming the ROADMAP item for a config
    outside the ported slice (never a silent reroute)."""
    if cfg.kind not in _SLICE:
        item = _UNPORTED_KINDS.get(cfg.kind, "A8")
        raise NotImplementedError(
            f"SparsifierConfig.kind={cfg.kind!r} is not ported yet; the "
            f"port serves {tuple(_SLICE)} (ROADMAP {item})")
    if cfg.pipeline not in _PIPELINES:
        raise ValueError(f"unknown pipeline {cfg.pipeline!r} "
                         f"(expected one of {_PIPELINES})")
    selectors = _SELECTORS.get((_SLICE[cfg.kind], cfg.pipeline), ("exact",))
    for field, served, item in (("selector", selectors,
                                 "A8 (histogram selector)"),) + _COMMON:
        val = getattr(cfg, field)
        if val not in served:
            raise NotImplementedError(
                f"SparsifierConfig.{field}={val!r} is not ported yet for "
                f"kind={cfg.kind!r} pipeline={cfg.pipeline!r}; the port "
                f"serves {served} (ROADMAP {item})")


def selection(cfg: SparsifierConfig) -> str:
    """Where the config's top-k is decided: "local" (each worker selects
    and ships (value, index) pairs) or "sketch" (one shared mask decoded
    from the all-reduced CountSketch; values travel alone)."""
    check_supported(cfg)
    return _SLICE[cfg.kind]


def err_key(cfg: SparsifierConfig) -> str:
    """The error-feedback state's key: "err_prev" on the fused pipeline,
    "err" on the reference pipeline (as in the reference's layouts)."""
    return "err_prev" if cfg.pipeline == "fused" else "err"


def resolve_k(cfg: SparsifierConfig, j: int) -> int:
    if cfg.k:
        return int(min(cfg.k, j))
    return max(1, int(round(cfg.sparsity * j)))


def _dense_posterior(cfg: SparsifierConfig) -> bool:
    """REGTOP-k's dense posterior layout (reference pipeline,
    ``state_format="dense"``): a_prev, s_prev and g_agg_prev J-vectors."""
    return (cfg.kind == "regtopk" and cfg.pipeline == "reference"
            and cfg.state_format != "sparse")


def init_state(cfg: SparsifierConfig, j: int, device) -> dict:
    """Zero state for a J-length flat gradient: the error state
    (``err_key``) and ``step``; DGC adds its momentum ``mom`` (J,);
    REGTOP-k adds the dense posterior (a_prev, s_prev, g_agg_prev, each
    (J,)) or the O(k) one (idx_prev, a_prev_sel, g_prev_sel)."""
    check_supported(cfg)

    def zeros(n, dtype=torch.float32):
        return torch.zeros(n, dtype=dtype, device=device)
    st = {err_key(cfg): zeros(j), "step": zeros((), torch.int32)}
    if cfg.kind == "dgc":
        st["mom"] = zeros(j)
    if _dense_posterior(cfg):
        st.update(a_prev=zeros(j), s_prev=zeros(j), g_agg_prev=zeros(j))
    elif cfg.kind == "regtopk":
        k = resolve_k(cfg, j)
        st.update(idx_prev=zeros(k, torch.int32), a_prev_sel=zeros(k),
                  g_prev_sel=zeros(k))
    return st


def _release(state: dict, donate: bool, *keys) -> None:
    """Drop the caller's J-vectors once they have been read, so that the
    old and the new state are not alive at once (``donate=True``)."""
    if donate:
        for key in keys:
            state.pop(key, None)


def compress(cfg: SparsifierConfig, state: dict, g: torch.Tensor,
             omega: float = 1.0, *, donate: bool = False,
             participate=None) -> CompressOut:
    """Sparsify one worker's flat fp32 gradient; omega = its weight w_n.
    The new state holds new buffers (the reference pipeline's a becomes
    a_prev as it is). ``state`` is only read, unless ``donate``: then the
    reference pipeline removes the J-vectors it has consumed from the
    dict as soon as it has read them, and the caller must not use the
    old state again. ``participate`` is the worker's elastic
    participation bit (a 0-d bool tensor on g's device; None: always in,
    the bits of the non-elastic path, as is a true bit)."""
    if selection(cfg) == "sketch":
        raise RuntimeError("sketchtopk selection is aggregate-level; run "
                           "it through aggregate.GradientSync (call or "
                           "round)")
    k = resolve_k(cfg, g.numel())
    g = g.float()
    p = None if participate is None else participate.reshape(())
    if cfg.pipeline == "fused":
        return _compress_fused(cfg, state, g, k, omega, p)
    if p is not None:
        # the fused pipeline's masked inputs, so that both pipelines'
        # states stay bit-comparable under any mask
        from repro_torch.kernels.compress.kernel import masked_inputs
        g, err = masked_inputs(g, state["err"], p, cfg.err_decay)
        if not donate:
            state = dict(state)
        state["err"] = err              # a donated old err is freed here
        del err
    if cfg.kind == "dgc":
        return _compress_dgc(cfg, state, g, k, donate, p)
    if cfg.kind == "regtopk" and not _dense_posterior(cfg):
        return _compress_regtopk_sparse(cfg, state, g, k, omega, donate, p)
    new = {"step": state["step"] + 1}
    frozen = {}
    with record_function("compress/scores"):
        if cfg.kind == "topk":
            a = state["err"] + g
            score = a
        else:
            a, score = fef.fused_regtopk_scores(
                g, state["err"], state["a_prev"], state["g_agg_prev"],
                state["s_prev"], omega=omega, mu=cfg.mu, Q=cfg.Q)
            # t = 0: plain TOP-k. Not redundant: a * reg with a constant
            # reg < 1 can round distinct values of a into ties.
            torch.where(state["step"] == 0, a, score, out=score)
            new.update(a_prev=a, g_agg_prev=state["g_agg_prev"])
            if p is not None:
                # the posterior freeze below reads them
                frozen = {key: state[key] for key in ("a_prev", "s_prev")}
        _release(state, donate, "err", "a_prev", "s_prev")
    with record_function("compress/select"):
        mask, values, indices = _reference_select(cfg, a, score, k)
    del score
    mask, values, indices, count = _mask_elastic(p, mask, values, indices, k)
    with record_function("compress/apply"):
        ghat, new["err"] = fef.fused_apply_mask(a, mask)
    if cfg.kind == "regtopk":
        new["s_prev"] = mask
        if frozen:
            # a sitting-out worker neither sent nor observed: Algorithm
            # 1's t-1 quantities stay those of its last participating step
            new["a_prev"] = torch.where(p, a, frozen["a_prev"])
            new["s_prev"] = torch.where(p, mask, frozen["s_prev"])
    return CompressOut(new, values, indices, ghat=ghat, mask=mask,
                       count=count)


def _mask_elastic(p, mask, values, indices, k: int):
    """The reference pipeline's payload masking: a sitting-out worker's
    dense mask (if any) and packed pairs come back inert (mask 0, values
    0, indices 0, count 0); p None passes everything through with count
    None (all k slots live)."""
    if p is None:
        return mask, values, indices, None
    if mask is not None:
        mask = torch.where(p, mask, 0.0)
    count = torch.where(p, torch.full((), k, dtype=torch.int32,
                                      device=p.device), 0)
    if values is not None:
        values = torch.where(p, values, 0.0)
        indices = torch.where(p, indices, 0)
    return mask, values, indices, count


def _reference_select(cfg: SparsifierConfig, a: torch.Tensor,
                      score: torch.Tensor, k: int):
    """(mask, values, indices) by cfg.selector over the whole vector;
    packed pairs only for the exact selector (exactly k entries)."""
    if cfg.selector != "exact":
        return select.topk_mask(score, k, cfg.selector), None, None
    idx = select.topk_indices(score, k)
    mask = bigvec.mask_from_indices(a.numel(), idx, torch.float32)
    return mask, a[idx], bigvec.to_u32_bits(idx)


def _compress_dgc(cfg: SparsifierConfig, state: dict, g: torch.Tensor,
                  k: int, donate: bool, p=None) -> CompressOut:
    """DGC on the reference pipeline: the momentum update and a = err +
    mom' in plain tensor ops, the selector over a, ghat and err through
    the apply kernel, and the momentum masked as mom' * (1 - mask). A
    sitting-out worker's a leaves mom' out (the elastic gate)."""
    with record_function("compress/scores"):
        # mom' = momentum * mom + g, one rounding as the compiled
        # reference contracts it into a fused multiply-add
        mom = fma_f32(state["mom"], cfg.momentum, g)
        a = state["err"] + (mom if p is None else torch.where(p, mom, 0.0))
        _release(state, donate, "err", "mom")
    with record_function("compress/select"):
        mask, values, indices = _reference_select(cfg, a, a, k)
    mask, values, indices, count = _mask_elastic(p, mask, values, indices, k)
    with record_function("compress/apply"):
        ghat, err = fef.fused_apply_mask(a, mask)
        del a
        mom.mul_(1.0 - mask)             # in place on mom', a new buffer
    return CompressOut({"err": err, "mom": mom, "step": state["step"] + 1},
                       values, indices, ghat=ghat, mask=mask, count=count)


def _compress_regtopk_sparse(cfg: SparsifierConfig, state: dict,
                             g: torch.Tensor, k: int, omega: float,
                             donate: bool, p=None) -> CompressOut:
    """REGTOP-k with the O(k) posterior (state_format="sparse"): Delta
    is read at the support of s^{t-1} only, Q everywhere else. Plain
    tensor ops, exact top-k whatever the selector (as the reference).
    The dense ghat and mask are left to ``dense_ghat``/``dense_mask``
    (an O(k) scatter each), which the sparse comm never calls."""
    with record_function("compress/scores"):
        a = state["err"] + g
        _release(state, donate, "err")
        idx_p = bigvec.as_index(state["idx_prev"])
        a_sel = a[idx_p]
        # g_prev - omega * a_prev: one fused multiply-add, as compiled
        delta = (fma_f32(state["a_prev_sel"], -omega, state["g_prev_sel"])
                 / safe_denom(omega * a_sel))
        reg_sel = tanh_f32((1.0 + delta).abs() * recip_f32(cfg.mu))
        score = a * regularizer_factor(cfg.Q, cfg.mu)
        score[idx_p] = a_sel * reg_sel
        torch.where(state["step"] == 0, a, score, out=score)
    with record_function("compress/select"):
        idx = select.topk_indices(score, k)
    del score
    values = a[idx]
    indices = bigvec.to_u32_bits(idx)
    new = {"idx_prev": indices, "a_prev_sel": values,
           "g_prev_sel": state["g_prev_sel"],         # observe_aggregate
           "step": state["step"] + 1}
    # in place on a; a sitting-out worker's writes nothing (err keeps
    # the decayed a), its O(k) posterior is frozen and its payload inert
    new["err"] = bigvec.scatter_set_live_(a, idx, p, 0.0)
    if p is None:
        return CompressOut(new, values, indices)
    new["idx_prev"] = torch.where(p, indices, state["idx_prev"])
    new["a_prev_sel"] = torch.where(p, values, state["a_prev_sel"])
    _, values, indices, count = _mask_elastic(p, None, values, indices, k)
    return CompressOut(new, values, indices, count=count)


def _compress_fused(cfg: SparsifierConfig, state: dict, g: torch.Tensor,
                    k: int, omega: float, p=None) -> CompressOut:
    from repro_torch.kernels.compress import ops
    kwargs = {}
    if p is not None:
        kwargs = dict(participate=p, err_decay=cfg.err_decay)
    if cfg.kind == "regtopk":
        kwargs.update(idx_prev=state["idx_prev"],
                      a_prev_sel=state["a_prev_sel"],
                      g_prev_sel=state["g_prev_sel"])
    if cfg.kind == "dgc":
        kwargs.update(mom=state["mom"], momentum=cfg.momentum)
    out = ops.fused_compress_arrays(
        cfg.kind, g, state["err_prev"], state["step"], k=k,
        omega=omega, mu=cfg.mu, Q=cfg.Q, **kwargs)
    new = {"err_prev": out["err"], "step": state["step"] + 1}
    if cfg.kind == "dgc":
        new["mom"] = out["mom"]             # selection-masked
    if cfg.kind == "regtopk":
        new["idx_prev"] = out["indices"]
        new["a_prev_sel"] = out["values"]
        new["g_prev_sel"] = torch.zeros_like(state["g_prev_sel"])
        if p is not None:
            # posterior freeze (O(k) selects): a sitting-out worker's t-1
            # support and values stay those of its last participating
            # step; observe_aggregate freezes g_prev_sel alike
            for key in ("idx_prev", "a_prev_sel", "g_prev_sel"):
                new[key] = torch.where(p, new[key], state[key])
    return CompressOut(new, out["values"], out["indices"], out["fallback"],
                       count=None if p is None else out["count"])


def observe_aggregate(cfg: SparsifierConfig, state: dict,
                      g_agg: torch.Tensor, participate=None) -> dict:
    """Store the aggregated gradient REGTOP-k's posterior reads: g_agg
    itself on the dense layout (no copy; the caller must not write into
    it), its O(k) gather at the support otherwise. A no-op for the other
    kinds. g_agg must be rank-identical (both combines guarantee it).
    A sitting-out worker (``participate`` false) observed nothing: its
    posterior keeps the g^{t-1} of its last participating step."""
    if cfg.kind != "regtopk":
        return state
    key = "g_agg_prev" if _dense_posterior(cfg) else "g_prev_sel"
    obs = g_agg if key == "g_agg_prev" else bigvec.gather(
        g_agg, state["idx_prev"])
    if participate is not None:
        obs = torch.where(participate.reshape(()), obs, state[key])
    return dict(state, **{key: obs})


def dense_mask(out: CompressOut, j: int) -> torch.Tensor:
    """Dense 0/1 fp32 selection mask: the reference pipeline's own, or
    rebuilt from the packed indices by an O(k) scatter (only the
    ``count`` live slots, where a count is given)."""
    if out.mask is not None:
        return out.mask
    live = None
    if out.count is not None:
        live = torch.arange(out.indices.numel(),
                            device=out.indices.device) < out.count
    return bigvec.mask_from_indices(j, out.indices, torch.float32, live)


def dense_ghat(out: CompressOut, j: int) -> torch.Tensor:
    """Dense sparsified gradient: the reference pipeline's own, or rebuilt
    from the packed pairs by an O(k) scatter-add into zeros (the
    reference's scatter-set gives the same bits: the k indices are
    distinct and a selected value is never -0.0, since a = err + g and
    no error state holds -0.0)."""
    if out.ghat is not None:
        return out.ghat
    ghat = torch.zeros(j, dtype=out.values.dtype, device=out.values.device)
    return bigvec.scatter_add_(ghat, out.indices, out.values)
