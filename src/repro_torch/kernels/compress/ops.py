"""The fused compression steps for one worker (the port of
``repro.kernels.compress.ops``): the two-sweep compressor
(:func:`fused_compress_arrays`) and sweep 1 with the CountSketch encode
folded in (:func:`fused_sketch_encode`).

    sweep 1:   a, score, histogram             (kernel.sweep1 per bucket;
               DGC's momentum update in its dgc mode)
    tail scan: tau from the merged histogram   (O(buckets x 2048))
    sweep 2:   per-tile candidate slots        (kernel.sweep2 per bucket)
    O(cand):   trim to k (the histogram selector: its capacity) with the
               REGTOP-k posterior corrections, exactness witnesses,
               packed (values, indices)
    O(k):      err_prev for the next step = a with the selected slots
               zeroed in place (and DGC's momentum likewise)

The slice of the reference the compressor covers: kind in
:data:`dispatch.FUSED_KINDS`, the exact selector or the histogram
selector (``selector="histogram"``: tau at the bit-pattern bin edge of
the k-th |score|, a fixed :func:`dispatch.hist_capacity` of packed
pairs with ``count`` live and inert pads, REGTOP-k's support of that
capacity with ``nsel_prev`` live slots), fp32 or bf16 error feedback
(``ef_dtype``: the state is read by sweep 1's bf16 read, the next state
cast before its O(k) scatter-zero), ``num_buckets`` >= 1 (one sweep 1
launch per contiguous bucket, the buckets' histograms merged into one
global tau, one sweep 2 launch per bucket: selection, packed order and
state bit for bit the flat call's), with or without a worker's elastic
participation bit. randk (:func:`_fused_randk`) is one elementwise
pass and an O(k) random gather, no kernel. Anything else raises before
any work (``core.sparsify.check_supported`` names the ROADMAP item).

Elastic participation (``participate``, a 0-d bool tensor) runs sweep 1
through its gated variant, which masks the inputs in registers: g_eff =
where(p, g, 0), err_eff = where(p, err, err_decay * err), and DGC's a
leaves the advanced momentum out when p is false. A sitting-out
worker's payload is inert (values 0, indices 0, count 0) and its O(k)
scatter-zeros of err and mom write nothing, so its next err_prev is
err_decay * err and DGC's mom is momentum * mom. p true gives the bits
of the ungated path.

The reference's ``lax.cond(ok, fast, fallback)`` becomes a host read of
``ok`` and a Python branch. The fallback (dense keys, exact top-k
over J) is part of the algorithm's semantics: it runs when a tile
overflowed its candidate slots or a boundary tie involves a corrected
support key, and it returns the same selection the reference's fallback
does. The result's ``fallback`` names why it ran ("" on the fast path):
"overflow" (a tile had more candidates than slots), "no_kth" (fewer than
k finite candidate keys) or "support_tie".
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.core import bigvec
from repro_torch.core.flatten import bucket_bounds
from repro_torch.core.numerics import (fma_f32, recip_f32,
                                       regularizer_factor, safe_denom,
                                       tanh_f32)
from repro_torch.core.select import randk_indices, topk_positions
from repro_torch.kernels.compress import kernel as pk
from repro_torch.kernels.compress.dispatch import FUSED_KINDS, hist_capacity


def maxpb_for(k: int, j: int) -> int:
    """Per-tile candidate slots: ~8x the mean selection density."""
    return int(min(pk.BLOCK, max(32, -(-8 * k * pk.BLOCK // j))))


def sweep_factor(kind: str, step: torch.Tensor, *, mu: float,
                 Q: float) -> torch.Tensor:
    """(1,) fp32 score factor c on step's device: tanh(|1+Q|/mu) for
    REGTOP-k after step 0, else 1 (TOP-k, DGC). No host read of
    ``step``."""
    one = torch.ones(1, dtype=torch.float32, device=step.device)
    if kind != "regtopk":
        return one
    return torch.where(step.reshape(1) == 0, one,
                       torch.full_like(one, regularizer_factor(Q, mu)))


def posterior_keys(a_sel, a_prev_sel, g_prev_sel, step, *, omega: float,
                   mu: float, support_valid=None) -> torch.Tensor:
    """|score| of the support entries (Algorithm 1 line 5, O(k)); -inf at
    step 0, when there is no support yet, and at the slots that
    ``support_valid`` marks dead (the histogram selector's inert pads)."""
    safe = safe_denom(omega * a_sel)
    # g_prev - omega * a_prev is one fused multiply-add in the compiled
    # reference (exact product, one rounding)
    delta = fma_f32(a_prev_sel, -omega, g_prev_sel) / safe
    skey = (a_sel * tanh_f32((1.0 + delta).abs() * recip_f32(mu))).abs()
    skey = torch.where(step == 0, torch.full_like(skey, float("-inf")), skey)
    if support_valid is not None:
        skey = torch.where(support_valid, skey, float("-inf"))
    return skey


def fused_compress_arrays(kind: str, g: torch.Tensor, err_prev: torch.Tensor,
                          step: torch.Tensor, *, k: int, omega: float = 1.0,
                          mu: float = 0.1, Q: float = 0.0,
                          momentum: float = 0.0, mom=None, idx_prev=None,
                          a_prev_sel=None, g_prev_sel=None, nsel_prev=None,
                          participate=None, err_decay: float = 1.0,
                          num_buckets: int = 1, selector: str = "exact",
                          key=None) -> dict:
    """One fused compression step. g (J,) fp32; err_prev (J,) fp32 or
    bf16 (the state's dtype, ``ef_dtype``: with bf16 the gradient is
    rounded to bf16 first, as the reference casts it); step a 0-d int32
    tensor; DGC also takes its momentum ``mom`` (J,), of err_prev's
    dtype, and its factor ``momentum``; REGTOP-k the O(k) posterior
    (idx_prev int32 bits, a_prev_sel, g_prev_sel fp32; with the
    histogram selector of capacity length, ``nsel_prev`` its live
    slots); randk the (2,) threefry ``key``. ``participate`` is the
    worker's elastic participation bit (0-d bool tensor on g's device,
    or None) and ``err_decay`` the decay of a sitting-out worker's
    error; ``num_buckets`` cuts the sweeps into contiguous buckets.
    Returns {"err": next err_prev (J,) of err_prev's dtype, "mom": DGC's
    next momentum or None, "values" fp32, "indices" int32 bits (k, or
    the capacity for the histogram selector), "count" 0-d int32 live
    slots, "fallback" reason or ""}, values ordered by |score|
    descending."""
    if kind not in FUSED_KINDS:
        raise NotImplementedError(
            f"fused kind={kind!r} is not ported (the fused kinds: "
            f"{FUSED_KINDS})")
    j = g.numel()
    k = int(min(k, j))
    if kind == "randk":
        return _fused_randk(g, err_prev, k, key, participate, err_decay)
    hist = selector == "histogram"
    kcap = hist_capacity(k, j) if hist else k
    regtopk = kind == "regtopk"
    bounds = bucket_bounds(j, num_buckets)
    with record_function("compress/sweeps"):
        c = sweep_factor(kind, step, mu=mu, Q=Q)
        a, score, mom_out, hists = _sweep1_buckets(
            g, err_prev, c, mom if kind == "dgc" else None, momentum,
            participate, err_decay, bounds)
        # margin kcap: REGTOP-k support corrections may drop <= kcap
        # entries below tau without breaking top-k coverage of the
        # candidates; the merged histogram is the whole vector's
        later = step > 0
        target = kcap + (later.to(torch.int64) * kcap if regtopk else 0)
        tau = pk.threshold_from_bucket_hists(hists, target)
        # per-tile slots from the global density, whatever the bucketing
        maxpb = maxpb_for(kcap, j)
        cand_k, cand_i, fits = _sweep2_buckets(score, tau, maxpb, bounds)
    with record_function("compress/trim"):
        return _trim(kind, a, score, cand_k, cand_i, fits, later, k, kcap,
                     omega=omega, mu=mu, step=step, idx_prev=idx_prev,
                     a_prev_sel=a_prev_sel, g_prev_sel=g_prev_sel,
                     nsel_prev=nsel_prev, mom_out=mom_out,
                     participate=participate, dtype=err_prev.dtype)


def _sweep1_buckets(g, err_prev, c, mom, momentum, participate, err_decay,
                    bounds):
    """Sweep 1 over each bucket (one launch each, writing into views of
    the (J,) outputs): (a, score, mom' or None, the buckets'
    histograms)."""
    gate = None
    if participate is not None:
        gate = participate.reshape(1).to(torch.float32)
    out = [torch.empty_like(g) for _ in range(2 if mom is None else 3)]
    hists = []
    for off, size in bounds:
        sl = slice(off, off + size)
        view = [x[sl] for x in out]
        ms = None if mom is None else mom[sl]
        if gate is None:
            res = pk.sweep1(g[sl], err_prev[sl], c, ms, momentum, out=view)
        else:
            res = pk.sweep1_gated(g[sl], err_prev[sl], c, gate, err_decay,
                                  ms, momentum, out=view)
        hists.append(res[3])
    return out[0], out[1], out[2] if mom is not None else None, hists


def _sweep2_buckets(score, tau, maxpb: int, bounds):
    """Sweep 2 over each bucket against the global tau: the candidates
    (keys, int64 global indices) in global index order, and whether
    every tile's candidates fit its slots (a 0-d bool tensor)."""
    keys, idx, fits = [], [], []
    for off, size in bounds:
        ck, ci, cnt = pk.sweep2(score[off:off + size], tau, maxpb)
        keys.append(ck)
        idx.append(bigvec.as_index(ci) + off)
        fits.append(cnt.max() <= maxpb)
    return torch.cat(keys), torch.cat(idx), torch.stack(fits).all()


def _fused_randk(g, err_prev, k, key, participate, err_decay) -> dict:
    """Fused RANDOM-k: a = err + g in one elementwise pass (the gradient
    rounded to a bf16 state's dtype first), the k positions of
    ``core.select.randk_indices`` (the reference pipeline's draw), the
    O(k) gather and the O(k) scatter-zero of the next state. No sweep
    kernel: selection reads no score."""
    if key is None:
        raise ValueError("randk needs a PRNG key")
    dtype = err_prev.dtype
    p = None if participate is None else participate.reshape(())
    with record_function("compress/sweeps"):
        g = g.to(dtype)
        if p is not None:
            g, err_prev = pk.masked_inputs(g, err_prev, p, err_decay)
        a = err_prev.float() + g.float()
    with record_function("compress/trim"):
        idx = randk_indices(key, a.numel(), k)
        values = a[idx]
        err = bigvec.scatter_set_live_(a.to(dtype), idx, p, 0.0)
        count = torch.full((), k, dtype=torch.int32, device=a.device)
        if p is not None:
            values = torch.where(p, values, 0.0)
            idx = torch.where(p, idx, 0)
            count = torch.where(p, count, 0)
    return {"err": err, "mom": None, "values": values,
            "indices": bigvec.to_u32_bits(idx), "count": count,
            "fallback": ""}


def _trim(kind, a, score, cand_k, cand_i, fits, later, k, kcap, *, omega,
          mu, step, idx_prev, a_prev_sel, g_prev_sel, nsel_prev, mom_out,
          participate, dtype) -> dict:
    """O(candidates) trim to kcap entries (k for the exact selector), the
    exactness witnesses, the fallback and the O(k) state writes of
    :func:`fused_compress_arrays`. The fallback ranks the dense keys of
    ``score``; its values are read from ``a``, which holds the bits the
    reference's fallback recomputes at the support (err + mom' for DGC,
    err + g otherwise, with the bf16 read's roundings)."""
    regtopk = kind == "regtopk"
    hist = kcap != k
    j = a.numel()
    support_valid = None
    if regtopk:
        idx_prev64 = bigvec.as_index(idx_prev)
        if nsel_prev is not None:
            support_valid = (torch.arange(idx_prev64.numel(), device=a.device)
                             < nsel_prev)
        skey = posterior_keys(a[idx_prev64], a_prev_sel, g_prev_sel, step,
                              omega=omega, mu=mu, support_valid=support_valid)
        # candidates that are support members carry an uncorrected key:
        # disable them (the corrected copy is appended below); membership
        # by sort + searchsorted in candidate space, O((k + cand) log k);
        # dead support slots go to the sentinel j first
        idx_live = (idx_prev64 if support_valid is None
                    else bigvec.live_idx(idx_prev64, support_valid, j))
        idx_sorted = torch.sort(idx_live).values
        pos = torch.searchsorted(idx_sorted, cand_i).clamp(
            max=idx_sorted.numel() - 1)
        hit = (idx_sorted[pos] == cand_i) & later
        cand_k = torch.where(hit, torch.full_like(cand_k, float("-inf")),
                             cand_k)
        allk = torch.cat([cand_k, skey])
        alli = torch.cat([cand_i, idx_prev64])
    else:
        allk, alli = cand_k, cand_i

    tsel = topk_positions(allk, kcap)
    tv = allk[tsel]
    kth = tv[k - 1]
    valid = kth > float("-inf")
    # the histogram selector's tau: the bin edge of the k-th key, which
    # the candidates (compacted at target kcap) cover
    tau = pk.key_bin_edge(kth) if hist else None
    ok = fits & valid
    if regtopk and not hist:
        # boundary ties among candidates resolve like the reference
        # (candidate order == global index order); a tie involving a
        # corrected SUPPORT key (appended last, out of index order) with
        # more ties than slots is ambiguous -> fallback
        n_gt = (allk > kth).sum()
        n_eq = (allk == kth).sum()
        support_tie = (skey == kth).any()
        ok = ok & ((n_eq == k - n_gt) | ~support_tie)

    fallback = ""
    if not bool(ok):                         # host read of the witnesses
        fallback = ("overflow" if not bool(fits) else
                    "no_kth" if not bool(valid) else "support_tie")
    if not fallback:
        idx_k = alli[tsel]
    else:
        with record_function("compress/fallback"):
            keys = score.abs()
            if regtopk:
                # dense keys with the corrected support keys written in
                # (a no-op at step 0 and at dead slots, which keep keys)
                live = later if support_valid is None else \
                    later & support_valid
                fix = torch.where(live, skey, keys[idx_prev64])
                bigvec.scatter_set_live_(keys, idx_prev64, support_valid,
                                         fix)
            idx_k = topk_positions(keys, kcap)
            if hist:
                tv = keys[idx_k]
                tau = pk.key_bin_edge(tv[k - 1])
            del keys
    p = None if participate is None else participate.reshape(())
    # a selected entry's value, gathered before a's buffer is cast and
    # zeroed (slots of empty candidates point past J: clamped, then
    # masked out below)
    values = a[idx_k.clamp(max=j - 1)]
    if hist:
        live = tv >= tau
        if p is not None:
            live = live & p
        values = torch.where(live, values, 0.0)
        idx_k = torch.where(live, idx_k, 0)
        count = live.sum(dtype=torch.int32)
    else:
        live = p
        count = torch.full((), k, dtype=torch.int32, device=a.device)
        if p is not None:
            values = torch.where(p, values, 0.0)
            count = torch.where(p, count, 0)
    # the next err_prev is a cast to the state's dtype (a's own buffer
    # when that is fp32) with the selected slots zeroed, and DGC's
    # momentum masking mom' * (1 - s) the same O(k) scatter-zero; dead
    # slots (pads, a sitting-out worker) write nothing
    err = bigvec.scatter_set_live_(a.to(dtype), idx_k, live, 0.0)
    if mom_out is not None:
        mom_out = bigvec.scatter_set_live_(mom_out.to(dtype), idx_k, live,
                                           0.0)
    if p is not None and not hist:
        idx_k = torch.where(p, idx_k, 0)
    return {"err": err, "mom": mom_out, "values": values,
            "indices": bigvec.to_u32_bits(idx_k), "count": count,
            "fallback": fallback}


def fused_sketch_encode(g: torch.Tensor, err_prev: torch.Tensor, *,
                        rows: int, width: int, tables: dict | None = None
                        ) -> dict:
    """The per-worker half of kind="sketchtopk" on the fused pipeline:
    a = err_prev + g and its (rows, width) CountSketch in one pass over
    g and err_prev (kernel ``sweep1_sketch``, which keeps its start
    tables in the caller's ``tables``). Returns {"a": (J,) fp32,
    "sketch": (rows, width) fp32}."""
    a, sk = pk.sweep1_sketch(g, err_prev, rows, width, tables)
    return {"a": a, "sketch": sk}
