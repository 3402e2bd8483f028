"""Gradient sparsifiers: TOP-k, DGC, REGTOP-k (the paper, Algorithm 1),
thresholdk and RANDOM-k on both pipelines, and the state of
sketch-coordinated TOP-k (the port of ``repro.core.sparsify``).

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
- "fused": the two-sweep pipeline (``kernels.compress.ops``), the exact
  selector or the histogram one (threshold at the bit-pattern bin edge
  of the k-th |score|, a fixed capacity of packed pairs with ``count``
  live), ``num_buckets`` contiguous buckets. The J-sized state is
  ``err_prev`` (= a^{t-1} * (1 - s^{t-1})), and DGC's ``mom``;
  REGTOP-k's posterior is O(k): ``idx_prev`` (int32 view of the uint32
  indices, doubling as the support set), ``a_prev_sel`` and
  ``g_prev_sel`` (with the histogram selector of its capacity, and
  ``nsel`` live slots).

thresholdk re-derives its threshold from the accumulator each step, so
it selects as topk does; randk selects k uniform positions from a
threefry key (``select.randk_indices``, the same draw on both
pipelines). ``ef_dtype="bfloat16"`` keeps the J-sized state and the
O(k) posterior values in bf16: the gradient is rounded to bf16 first,
as the reference casts it; the fused sweeps compute in fp32 (sweep 1's
bf16 read), the reference pipeline in bf16 operations as the
reference's compiled program rounds them: each op's fp32 result rounded
to bf16 with the Python constants rounded to bf16 first, but an op
whose result the program widens to fp32 keeps it (``_select_key``).
REGTOP-k's dense score runs through the ``scores_bf16`` kernel, its
O(k) layout in plain tensor ops; the histogram selectors bin the bf16
score in bf16.

A config that asks for the fused pipeline with a kind or a selector the
sweeps do not implement (``histogram_kernel``, the baselines) runs the
reference pipeline and its state layout, as the reference's dispatch
routes it (:func:`fused`).

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
state is ``err_prev`` (fused) or ``err`` (reference pipeline), of
``cfg.ef_dtype``, and ``step``. The two baselines keep ``step`` only, on
either pipeline: kind="none" (dense data-parallel SGD) compresses to the
gradient itself under an all-ones mask, and kind="globaltopk" (the
genie, the paper's §3.1) selects from the aggregate, so ``compress``
raises for it too.

The in-process round drivers of the paper experiments
(:func:`stack_states`, :func:`sparsified_round`, :func:`make_round_fn`)
delegate to ``core.aggregate.GradientSync``, as the reference's do.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch import trace
from repro_torch.configs.base import SparsifierConfig
from repro_torch.core import allocate, bigvec, select
from repro_torch.core.numerics import (bf16, fma_f32, recip_f32,
                                       regularizer_bf16, regularizer_factor,
                                       round_bf16, safe_denom,
                                       safe_denom_bf16, tanh_f32)
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


_PIPELINES = ("fused", "reference")
# per kind: where its top-k is decided
_SLICE = {"topk": "local", "dgc": "local", "regtopk": "local",
          "randk": "local", "thresholdk": "local",
          "sketchtopk": "sketch", "none": "none", "globaltopk": "global"}
_SELECTORS = ("exact", "histogram", "histogram_kernel")
_EF_DTYPES = ("float32", "bfloat16")


def check_supported(cfg: SparsifierConfig) -> None:
    """Raise the reference's ValueError for a config it does not define
    (never a silent reroute). Every config the reference's GradientSync
    builds is served, ``num_buckets=0`` (the bucket auto-tune,
    :func:`resolve_num_buckets`) included. A config that asks for the
    fused pipeline with a kind or selector the sweeps do not implement
    runs the reference pipeline, as the reference's dispatch routes it
    (``dispatch.fused_reason``)."""
    if cfg.kind not in _SLICE:
        raise ValueError(f"unknown sparsifier kind {cfg.kind!r} (expected "
                         f"one of {tuple(_SLICE)})")
    if cfg.pipeline not in _PIPELINES:
        raise ValueError(f"unknown pipeline {cfg.pipeline!r} "
                         f"(expected one of {_PIPELINES})")
    if cfg.selector not in _SELECTORS:
        raise ValueError(f"unknown selector {cfg.selector!r}")
    # the reference's ValueErrors first, in its GradientSync's order:
    # allocation needs a per-worker exact-k selection, streaming the
    # fused pipeline
    from repro_torch.kernels.compress.dispatch import check_overlap
    allocate.check_allocation(cfg)
    check_overlap(cfg)
    if cfg.num_buckets < 0:
        raise ValueError(f"num_buckets={cfg.num_buckets} < 0")
    if cfg.ef_dtype not in _EF_DTYPES:
        raise ValueError(f"unknown ef_dtype {cfg.ef_dtype!r} (expected one "
                         f"of {_EF_DTYPES})")


def selection(cfg: SparsifierConfig) -> str:
    """Where the config's top-k is decided: "local" (each worker selects
    and ships (value, index) pairs), "sketch" (one shared mask decoded
    from the all-reduced CountSketch; values travel alone), "global"
    (the genie: the top-k of the all-reduced dense gradient) or "none"
    (dense SGD: nothing is selected)."""
    check_supported(cfg)
    return _SLICE[cfg.kind]


def fused(cfg: SparsifierConfig) -> bool:
    """The fused pipeline serves cfg (``dispatch.fused``)."""
    from repro_torch.kernels.compress.dispatch import fused as _fused
    return _fused(cfg)


def err_key(cfg: SparsifierConfig) -> str:
    """The error-feedback state's key: "err_prev" on the fused pipeline,
    "err" on the reference pipeline (as in the reference's layouts)."""
    return "err_prev" if fused(cfg) else "err"


def resolve_k(cfg: SparsifierConfig, j: int) -> int:
    if cfg.k:
        return int(min(cfg.k, j))
    return max(1, int(round(cfg.sparsity * j)))


def resolve_num_buckets(cfg: SparsifierConfig, j: int,
                        n_workers: int = 1) -> int:
    """cfg.num_buckets, with 0 resolved to the auto-tuned count: the
    sparse collective's payload, n_workers * packed_len * 8 bytes,
    against the collective launch floor (``roofline.analysis.
    auto_num_buckets``, the H100's constants). Deterministic in (cfg, j,
    n_workers), so ``num_buckets=<resolved>`` written out runs the same
    bits (bucketing never changes the selection)."""
    if cfg.num_buckets != 0:
        return max(1, int(cfg.num_buckets))
    from repro_torch.kernels.compress.dispatch import packed_len
    from repro_torch.roofline.analysis import auto_num_buckets
    return auto_num_buckets(packed_len(cfg, j), n_workers)


def _workers_from_omega(omega) -> int:
    """The equal-weight worker count that omega = 1/N implies (all that
    a bare compress() call knows for the bucket auto-tune; the sync
    resolves from its group's size instead). A tensor omega is an error,
    not a silent N=1 and not a read of the device: resolve the bucket
    count upstream then."""
    if isinstance(omega, torch.Tensor):
        raise TypeError(
            "num_buckets=0 auto-tune inside compress() needs a concrete "
            "omega (= 1/N) to infer the worker count; with a traced "
            "omega, resolve the bucket count upstream via "
            "sparsify.resolve_num_buckets or aggregate.sync_gradient.")
    try:
        return max(1, int(round(1.0 / float(omega))))
    except (TypeError, ValueError, ZeroDivisionError):
        return 1


def state_dtype(cfg: SparsifierConfig) -> torch.dtype:
    """The dtype of the J-sized state and of REGTOP-k's O(k) values
    (``cfg.ef_dtype``)."""
    return getattr(torch, cfg.ef_dtype)


def _dense_posterior(cfg: SparsifierConfig) -> bool:
    """REGTOP-k's dense posterior layout (reference pipeline,
    ``state_format="dense"``): a_prev, s_prev and g_agg_prev J-vectors."""
    return (cfg.kind == "regtopk" and not fused(cfg)
            and cfg.state_format != "sparse")


def init_state(cfg: SparsifierConfig, j: int, device) -> dict:
    """Zero state for a J-length flat gradient: the error state
    (``err_key``) and ``step``; DGC adds its momentum ``mom`` (J,);
    REGTOP-k adds the dense posterior (a_prev, s_prev, g_agg_prev, each
    (J,)) or the O(k) one (idx_prev, a_prev_sel, g_prev_sel, of the
    packed length: the fused histogram selector's capacity, with its
    live count ``nsel``). Vectors and the O(k) values are of
    ``cfg.ef_dtype``. The baselines (kinds none and globaltopk) keep
    ``step`` only."""
    from repro_torch.kernels.compress.dispatch import (fused_histogram,
                                                       packed_len)
    dt = state_dtype(cfg)

    def zeros(n, dtype=dt):
        return torch.zeros(n, dtype=dtype, device=device)
    if selection(cfg) in ("none", "global"):
        return {"step": zeros((), torch.int32)}
    st = {err_key(cfg): zeros(j), "step": zeros((), torch.int32)}
    if cfg.kind == "dgc":
        st["mom"] = zeros(j)
    if _dense_posterior(cfg):
        st.update(a_prev=zeros(j), s_prev=zeros(j), g_agg_prev=zeros(j))
    elif cfg.kind == "regtopk":
        kp = packed_len(cfg, j)
        st.update(idx_prev=zeros(kp, torch.int32), a_prev_sel=zeros(kp),
                  g_prev_sel=zeros(kp))
        if fused_histogram(cfg):
            st["nsel"] = zeros((), torch.int32)
    return st


def _release(state: dict, donate: bool, *keys) -> None:
    """Drop the caller's J-vectors once they have been read, so that the
    old and the new state are not alive at once (``donate=True``)."""
    if donate:
        for key in keys:
            state.pop(key, None)


def compress(cfg: SparsifierConfig, state: dict, g, omega: float = 1.0, *,
             donate: bool = False, participate=None, key=None,
             seg_bounds=None, g_segments=None) -> CompressOut:
    """Sparsify one worker's flat fp32 gradient; omega = its weight w_n.
    The new state holds new buffers (the reference pipeline's a becomes
    a_prev as it is). ``state`` is only read, unless ``donate``: then the
    reference pipeline removes the J-vectors it has consumed from the
    dict as soon as it has read them, and the caller must not use the
    old state again. ``participate`` is the worker's elastic
    participation bit (a 0-d bool tensor on g's device; None: always in,
    the bits of the non-elastic path, as is a true bit). Kind none
    returns the gradient as ``ghat`` under an all-ones ``mask`` (both
    zero for a sitting-out worker). randk draws its indices from ``key``
    (a (2,) threefry key, ``core.threefry``). With a bf16 ``ef_dtype``
    the gradient is rounded to bf16 first, as the reference casts it.

    ``cfg.allocation`` "proportional" or "adaptive" splits k over the
    segments ``seg_bounds`` ([(offset, size), ...]; by default the
    near-equal cut of ``allocate.resolve_num_segments``) on either
    pipeline. ``cfg.overlap="backward"`` (fused pipeline) cuts the sweeps
    by the stream's partition: the segments of ``g_segments`` (per-segment
    arrays in place of ``g``, which must then be None), or for a flat g
    the allocation's segments, else the resolved near-equal cut; the
    output is the flat call's, bit for bit. With both, one partition
    drives the stream and the allocation."""
    sel = selection(cfg)
    if sel == "global":
        raise RuntimeError("globaltopk is aggregate-level; run it through "
                           "aggregate.GradientSync (sync or round)")
    if sel == "sketch":
        raise RuntimeError("sketchtopk selection is aggregate-level; run "
                           "it through aggregate.GradientSync (call or "
                           "round)")
    if g_segments is not None:
        if g is not None:
            raise ValueError("pass g or g_segments, not both")
        if cfg.overlap != "backward":
            raise ValueError("g_segments requires overlap='backward'")
        j = sum(int(gs.numel()) for gs in g_segments)
    else:
        j = g.numel()
    k = resolve_k(cfg, j)
    p = None if participate is None else participate.reshape(())
    if cfg.num_buckets == 0:
        # before the partitions: num_segments=0 follows the resolved count
        cfg = replace(cfg, num_buckets=resolve_num_buckets(
            cfg, j, _workers_from_omega(omega)))
    seg_bounds, stream_bounds = partitions(
        cfg, j, seg_bounds, None if g_segments is None else
        [int(gs.numel()) for gs in g_segments])
    if sel == "local" and fused(cfg):
        step = begin_fused(cfg, state, j, omega, participate=p, key=key,
                           seg_bounds=seg_bounds, stream_bounds=stream_bounds)
        for pos, (off, size) in enumerate(step.bounds):
            step.feed(pos, g[off:off + size] if g_segments is None
                      else g_segments[pos])
        return step.finish()
    g = g.float()
    if sel == "none":
        g = g.to(state_dtype(cfg))
        ones = torch.ones_like(g)
        if p is not None:
            g, ones = torch.where(p, g, 0.0), torch.where(p, ones, 0.0)
        return CompressOut({"step": state["step"] + 1}, None, None,
                           ghat=g, mask=ones)
    if not _dense_posterior(cfg):
        # the dense posterior's score kernel rounds g to bf16 itself
        g = g.to(state_dtype(cfg))
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
        return _compress_dgc(cfg, state, g, k, donate, p, seg_bounds)
    if cfg.kind == "randk":
        return _compress_randk(cfg, state, g, k, key, donate, p, seg_bounds)
    if cfg.kind == "regtopk" and not _dense_posterior(cfg):
        return _compress_regtopk_sparse(cfg, state, g, k, omega, donate, p)
    new = {"step": state["step"] + 1}
    frozen = {}
    with trace.span("compress/scores"):
        if cfg.kind != "regtopk":
            # topk, and thresholdk, which re-derives its threshold from
            # the accumulator each step and so selects as topk does
            a = state["err"] + g
            score = _select_key(a, state["err"], g)
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
    with trace.span("compress/select"):
        mask, values, indices = _reference_select(cfg, a, score, k,
                                                  seg_bounds)
    del score
    mask, values, indices, count = _mask_elastic(p, mask, values, indices, k)
    with trace.span("compress/apply"):
        ghat, new["err"] = _apply(a, mask)
    if cfg.kind == "regtopk":
        new["s_prev"] = mask
        if frozen:
            # a sitting-out worker neither sent nor observed: Algorithm
            # 1's t-1 quantities stay those of its last participating step
            new["a_prev"] = torch.where(p, a, frozen["a_prev"])
            new["s_prev"] = torch.where(p, mask, frozen["s_prev"])
    return CompressOut(new, values, indices, ghat=ghat, mask=mask,
                       count=count)


def _select_key(a: torch.Tensor, err: torch.Tensor, x: torch.Tensor):
    """The score the selection ranks for a = err + x: a itself, or with a
    bf16 state the sum in fp32 before its rounding to bf16. The
    reference's compiled program computes a bf16 op whose result the
    program widens to fp32 in fp32 and drops its rounding (the stored a
    is rounded): the selection's fp32 keys and the histogram kernel's
    input read it so."""
    if a.dtype == torch.float32:
        return a
    return err.float() + x.float()


def _apply(a: torch.Tensor, mask: torch.Tensor):
    """(ghat, err) = (mask * a, a - mask * a) through the apply kernel on
    fp32 operands, returned in a's dtype (exact: each is a or 0)."""
    ghat, err = fef.fused_apply_mask(a, mask)
    if a.dtype != torch.float32:
        ghat, err = ghat.to(a.dtype), err.to(a.dtype)
    return ghat, err


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
                      score: torch.Tensor, k: int, seg_bounds=None):
    """(mask, values, indices) by cfg.selector over the whole vector;
    packed pairs only for the exact selector (exactly k entries). An
    allocated mode selects per segment of ``seg_bounds``
    (``allocate.reference_allocated_select``), exactly k entries."""
    if cfg.allocation != "global":
        return allocate.reference_allocated_select(cfg, a, score, k,
                                                   seg_bounds)
    if cfg.selector == "histogram_kernel" and a.dtype != score.dtype:
        # the kernel reads the widened fp32 key (unrounded, see
        # _select_key); its threshold rounds to a's dtype and the mask
        # compares the score in that dtype
        from repro_torch.kernels.topk_select.ops import \
            histogram_threshold_op
        tau = histogram_threshold_op(score, k).to(a.dtype)
        return (score.to(a.dtype).abs() >= tau).to(a.dtype), None, None
    if cfg.selector != "exact":
        # the histogram selector bins the score in its own dtype (bf16
        # under a bf16 state; the mask comes back in it)
        return select.topk_mask(score.to(a.dtype), k, cfg.selector), \
            None, None
    idx = select.topk_indices(score, k)
    mask = bigvec.mask_from_indices(a.numel(), idx, a.dtype)
    return mask, a[idx], bigvec.to_u32_bits(idx)


def _compress_randk(cfg: SparsifierConfig, state: dict, g: torch.Tensor,
                    k: int, key, donate: bool, p=None,
                    seg_bounds=None) -> CompressOut:
    """RANDOM-k on the reference pipeline: a = err + g, the k positions
    of ``select.randk_indices(key)`` (the fused pipeline's draw; an
    allocated mode draws each segment's proportional count with
    ``allocate.randk_allocated_indices``), the dense mask and the packed
    pairs, ghat and err through the apply kernel."""
    if key is None:
        raise ValueError("randk needs a PRNG key")
    with trace.span("compress/scores"):
        a = state["err"] + g
        _release(state, donate, "err")
    with trace.span("compress/select"):
        if cfg.allocation != "global":
            idx = allocate.randk_allocated_indices(
                key, seg_bounds, allocate.proportional_counts(
                    k, [size for _, size in seg_bounds]))
        else:
            idx = select.randk_indices(key, a.numel(), k)
        mask = bigvec.mask_from_indices(a.numel(), idx, a.dtype)
        values, indices = a[idx], bigvec.to_u32_bits(idx)
    mask, values, indices, count = _mask_elastic(p, mask, values, indices, k)
    with trace.span("compress/apply"):
        ghat, err = _apply(a, mask)
    return CompressOut({"err": err, "step": state["step"] + 1}, values,
                       indices, ghat=ghat, mask=mask, count=count)


def _compress_dgc(cfg: SparsifierConfig, state: dict, g: torch.Tensor,
                  k: int, donate: bool, p=None,
                  seg_bounds=None) -> CompressOut:
    """DGC on the reference pipeline: the momentum update and a = err +
    mom' in plain tensor ops, the selector over a, ghat and err through
    the apply kernel, and the momentum masked as mom' * (1 - mask). A
    sitting-out worker's a leaves mom' out (the elastic gate)."""
    with trace.span("compress/scores"):
        if g.dtype == torch.float32:
            # mom' = momentum * mom + g, one rounding as the compiled
            # reference contracts it into a fused multiply-add
            mom = fma_f32(state["mom"], cfg.momentum, g)
        else:
            # bf16 state: the reference rounds every operation to bf16,
            # the momentum constant included (the product of two bf16
            # values is exact in fp32)
            m = torch.tensor(cfg.momentum, dtype=g.dtype).float().item()
            mom = (state["mom"].float() * m).to(g.dtype) + g
        am = mom if p is None else torch.where(p, mom, 0.0)
        a = state["err"] + am
        score = _select_key(a, state["err"], am)
        _release(state, donate, "err", "mom")
        del am
    with trace.span("compress/select"):
        mask, values, indices = _reference_select(cfg, a, score, k,
                                                  seg_bounds)
        del score
    mask, values, indices, count = _mask_elastic(p, mask, values, indices, k)
    with trace.span("compress/apply"):
        ghat, err = _apply(a, mask)
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
    with trace.span("compress/scores"):
        a = state["err"] + g
        _release(state, donate, "err")
        idx_p = bigvec.as_index(state["idx_prev"])
        if a.dtype == torch.float32:
            a_sel = a[idx_p]
            # g_prev - omega * a_prev: one fused multiply-add, as compiled
            delta = (fma_f32(state["a_prev_sel"], -omega,
                             state["g_prev_sel"])
                     / safe_denom(omega * a_sel))
            reg_sel = tanh_f32((1.0 + delta).abs() * recip_f32(cfg.mu))
            score = a * regularizer_factor(cfg.Q, cfg.mu)
            score[idx_p] = a_sel * reg_sel
            torch.where(state["step"] == 0, a, score, out=score)
        else:
            # bf16 state: every operation rounded to bf16 as compiled
            # (no fused multiply-add between two roundings), the
            # constants rounded to bf16
            af = a.float()
            a_sel = af[idx_p]
            om = bf16(omega)
            delta = round_bf16(
                round_bf16(state["g_prev_sel"].float()
                           - round_bf16(om * state["a_prev_sel"].float()))
                / safe_denom_bf16(round_bf16(om * a_sel)))
            score = round_bf16(af * bf16(regularizer_factor(cfg.Q, cfg.mu)))
            score[idx_p] = round_bf16(a_sel * regularizer_bf16(delta,
                                                               cfg.mu))
            torch.where(state["step"] == 0, af, score, out=score)
            del af
    with trace.span("compress/select"):
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


def partitions(cfg: SparsifierConfig, j: int, seg_bounds=None,
               stream_sizes=None):
    """(seg_bounds, stream_bounds) of a config at J: the allocation's
    segments (``seg_bounds`` as given, or the near-equal cut of
    ``allocate.resolve_num_segments``; None for allocation="global") and
    the stream's partition under ``overlap="backward"`` (the segments of
    ``stream_sizes`` when the gradient comes as such, else the
    allocation's, else the near-equal cut; None without overlap). With
    both, one partition drives both: a given ``seg_bounds`` must equal
    the stream's."""
    allocated = cfg.allocation != "global"
    if seg_bounds is not None:
        seg_bounds = [tuple(b) for b in seg_bounds]
    stream_bounds = None
    if stream_sizes is not None:
        stream_bounds, off = [], 0
        for size in stream_sizes:
            stream_bounds.append((off, size))
            off += size
        if allocated:
            if seg_bounds is None:
                seg_bounds = stream_bounds
            elif seg_bounds != stream_bounds:
                raise ValueError(
                    "streaming with allocation != 'global' needs "
                    "seg_bounds == the g_segments partition")
    if allocated and seg_bounds is None:
        seg_bounds = allocate.segment_bounds(
            j, allocate.resolve_num_segments(cfg, j))
    if cfg.overlap == "backward" and stream_bounds is None:
        stream_bounds = seg_bounds if allocated else allocate.segment_bounds(
            j, allocate.resolve_num_segments(cfg, j))
    return seg_bounds if allocated else None, stream_bounds


def begin_fused(cfg: SparsifierConfig, state: dict, j: int,
                omega: float = 1.0, *, participate=None, key=None,
                seg_bounds=None, stream_bounds=None) -> "FusedCompress":
    """Open one fused compress step over a J-length gradient that will
    come one segment at a time (:class:`FusedCompress`): the sweeps'
    partition is ``stream_bounds``, else the allocation's
    ``seg_bounds``, else the buckets."""
    return FusedCompress(cfg, state, j, omega, participate, key, seg_bounds,
                         stream_bounds)


class FusedCompress:
    """A fused compress step fed segment by segment (``kernels.compress.
    ops.FusedStep`` on this config and state): :meth:`feed` sweeps
    segment ``pos`` of :attr:`bounds` as soon as its gradient exists,
    :meth:`finish` returns the :class:`CompressOut` of :func:`compress`."""

    def __init__(self, cfg, state, j, omega, p, key, seg_bounds,
                 stream_bounds):
        from repro_torch.kernels.compress import ops
        from repro_torch.kernels.compress.dispatch import fused_histogram
        self.cfg, self.state, self.p = cfg, state, p
        self.hist = fused_histogram(cfg)
        kwargs = {}
        if p is not None:
            kwargs = dict(participate=p, err_decay=cfg.err_decay)
        if cfg.kind == "regtopk":
            kwargs.update(idx_prev=state["idx_prev"],
                          a_prev_sel=state["a_prev_sel"].float(),
                          g_prev_sel=state["g_prev_sel"].float(),
                          nsel_prev=state["nsel"] if self.hist else None)
        if cfg.kind == "dgc":
            kwargs.update(mom=state["mom"], momentum=cfg.momentum)
        self.step = ops.FusedStep(
            cfg.kind, state["err_prev"], state["step"], k=resolve_k(cfg, j),
            omega=omega, mu=cfg.mu, Q=cfg.Q, num_buckets=cfg.num_buckets,
            selector="histogram" if self.hist else "exact", key=key,
            allocation=cfg.allocation, seg_bounds=seg_bounds,
            bounds=stream_bounds, **kwargs)
        self.bounds = self.step.bounds

    def feed(self, pos: int, g_seg: torch.Tensor) -> None:
        self.step.feed(pos, g_seg.float())

    def finish(self) -> CompressOut:
        cfg, state, p, hist = self.cfg, self.state, self.p, self.hist
        out = self.step.finish()
        new = {"err_prev": out["err"], "step": state["step"] + 1}
        if cfg.kind == "dgc":
            new["mom"] = out["mom"]             # selection-masked
        if cfg.kind == "regtopk":
            new["idx_prev"] = out["indices"]
            new["a_prev_sel"] = out["values"].to(state_dtype(cfg))
            new["g_prev_sel"] = torch.zeros_like(state["g_prev_sel"])
            if hist:
                new["nsel"] = out["count"]
            if p is not None:
                # posterior freeze (O(k) selects): a sitting-out worker's
                # t-1 support and values stay those of its last
                # participating step; observe_aggregate freezes
                # g_prev_sel alike
                for name in ("idx_prev", "a_prev_sel", "g_prev_sel") + (
                        ("nsel",) if hist else ()):
                    new[name] = torch.where(p, new[name], state[name])
        count = out["count"] if p is not None or hist else None
        return CompressOut(new, out["values"], out["indices"],
                           out["fallback"], count=count)


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
    obs = (g_agg if key == "g_agg_prev" else bigvec.gather(
        g_agg, state["idx_prev"])).to(state_dtype(cfg))
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


# ---------------------------------------------------------------------------
# In-process multi-worker drivers (tests, the paper experiments)
# ---------------------------------------------------------------------------

def stack_states(states: list) -> dict:
    """N workers' state dicts -> one dict of (N, ...) tensors."""
    return {key: torch.stack([st[key] for st in states]) for key in states[0]}


def unstack_states(states: dict, n: int) -> list:
    """Inverse of :func:`stack_states`: N dicts of views, one a worker."""
    return [{key: val[i] for key, val in states.items()} for i in range(n)]


def make_round_fn(cfg: SparsifierConfig, n_workers: int):
    """An aggregation round over stacked worker states (leading axis N)
    and grads (N, J), equal weights 1/N: returns (g_agg, new stacked
    states). A delegate to ``core.aggregate.GradientSync.make_round_fn``,
    as the reference's is."""
    from repro_torch.core import aggregate
    return aggregate.GradientSync(cfg).make_round_fn(n_workers)


def sparsified_round(cfg: SparsifierConfig, states: list, grads: list,
                     omegas: Optional[list] = None,
                     participate: Optional[list] = None, key=None):
    """One aggregation round over N in-process workers: a delegate to
    ``core.aggregate.GradientSync.round`` (randk: worker i draws with
    ``fold_in(key, i)``). Returns (g_agg, new_states)."""
    from repro_torch.core import aggregate
    return aggregate.GradientSync(cfg).round(states, grads, omegas=omegas,
                                             participate=participate,
                                             key=key)
