"""The fused compression steps for one worker (the port of
``repro.kernels.compress.ops``): the two-sweep compressor
(:func:`fused_compress_arrays`) and sweep 1 with the CountSketch encode
folded in (:func:`fused_sketch_encode`).

    sweep 1:   a, score, histogram             (kernel.sweep1; DGC's
               momentum update in its dgc mode)
    tail scan: tau from the histogram          (O(2048))
    sweep 2:   per-tile candidate slots        (kernel.sweep2)
    O(cand):   exact-k trim with the REGTOP-k posterior corrections,
               exactness witnesses, packed (values, indices)
    O(k):      err_prev for the next step = a with the selected slots
               zeroed in place (and DGC's momentum likewise)

The slice of the reference the compressor covers: kind in {topk, dgc,
regtopk}, the exact selector, one bucket, fp32 error feedback, with or
without a worker's elastic participation bit. Anything else raises
before any work (``core.sparsify.check_supported`` names the ROADMAP
item).

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
from repro_torch.core.numerics import (fma_f32, recip_f32,
                                       regularizer_factor, safe_denom,
                                       tanh_f32)
from repro_torch.core.select import topk_positions
from repro_torch.kernels.compress import kernel as pk

FUSED_KINDS = ("topk", "dgc", "regtopk")


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
                   mu: float) -> torch.Tensor:
    """|score| of the support entries (Algorithm 1 line 5, O(k)); -inf at
    step 0, when there is no support yet."""
    safe = safe_denom(omega * a_sel)
    # g_prev - omega * a_prev is one fused multiply-add in the compiled
    # reference (exact product, one rounding)
    delta = fma_f32(a_prev_sel, -omega, g_prev_sel) / safe
    skey = (a_sel * tanh_f32((1.0 + delta).abs() * recip_f32(mu))).abs()
    return torch.where(step == 0, torch.full_like(skey, float("-inf")), skey)


def fused_compress_arrays(kind: str, g: torch.Tensor, err_prev: torch.Tensor,
                          step: torch.Tensor, *, k: int, omega: float = 1.0,
                          mu: float = 0.1, Q: float = 0.0,
                          momentum: float = 0.0, mom=None, idx_prev=None,
                          a_prev_sel=None, g_prev_sel=None,
                          participate=None, err_decay: float = 1.0) -> dict:
    """One fused compression step. g, err_prev (J,) fp32; step a 0-d int32
    tensor; DGC also takes its momentum ``mom`` (J,) fp32 and its factor
    ``momentum``;
    REGTOP-k the O(k) posterior (idx_prev int32 bits, a_prev_sel,
    g_prev_sel). ``participate`` is the worker's elastic participation
    bit (0-d bool tensor on g's device, or None) and ``err_decay`` the
    decay of a sitting-out worker's error. Returns {"err": next err_prev
    (J,) — the buffer of ``a``, "mom": DGC's next momentum (J,) — the
    buffer of mom' — or None, "values" (k,) fp32, "indices" (k,) int32
    bits, "count" 0-d int32 (k, or 0 for a sitting-out worker),
    "fallback" reason or ""}, values ordered by |score| descending."""
    if kind not in FUSED_KINDS:
        raise NotImplementedError(
            f"fused kind={kind!r} is not ported yet (ROADMAP A8)")
    j = g.numel()
    k = int(min(k, j))
    regtopk = kind == "regtopk"
    with record_function("compress/sweeps"):
        c = sweep_factor(kind, step, mu=mu, Q=Q)
        dgc_mom = mom if kind == "dgc" else None
        if participate is None:
            a, score, _amax, hist, *mom_out = pk.sweep1(
                g, err_prev, c, dgc_mom, momentum)
        else:
            gate = participate.reshape(1).to(torch.float32)
            a, score, _amax, hist, *mom_out = pk.sweep1_gated(
                g, err_prev, c, gate, err_decay, dgc_mom, momentum)
        # margin k: REGTOP-k support corrections may drop <= k entries
        # below tau without breaking top-k coverage of the candidates
        later = step > 0
        target = k + (later.to(torch.int64) * k if regtopk else 0)
        tau = pk.threshold_from_hist(hist, target)
        maxpb = maxpb_for(k, j)
        cand_k, cand_i32, cnt = pk.sweep2(score, tau, maxpb)
    with record_function("compress/trim"):
        return _trim(kind, a, score, cand_k, bigvec.as_index(cand_i32),
                     cnt.max() <= maxpb, later, k, omega=omega, mu=mu,
                     step=step, idx_prev=idx_prev, a_prev_sel=a_prev_sel,
                     g_prev_sel=g_prev_sel,
                     mom_out=mom_out[0] if mom_out else None,
                     participate=participate)


def _trim(kind, a, score, cand_k, cand_i, fits, later, k, *, omega, mu,
          step, idx_prev, a_prev_sel, g_prev_sel, mom_out,
          participate) -> dict:
    """O(candidates) exact-k trim, the exactness witnesses, the fallback
    and the O(k) state writes of :func:`fused_compress_arrays`. The
    fallback ranks the dense keys of ``score``; its values are read from
    ``a``, which holds the bits the reference's fallback recomputes at
    the support (err + mom' for DGC, err + g otherwise)."""
    regtopk = kind == "regtopk"
    if regtopk:
        idx_prev64 = bigvec.as_index(idx_prev)
        skey = posterior_keys(a[idx_prev64], a_prev_sel, g_prev_sel, step,
                              omega=omega, mu=mu)
        # candidates that are support members carry an uncorrected key:
        # disable them (the corrected copy is appended below); membership
        # by sort + searchsorted in candidate space, O((k + cand) log k)
        idx_sorted = torch.sort(idx_prev64).values
        pos = torch.searchsorted(idx_sorted, cand_i).clamp(
            max=idx_sorted.numel() - 1)
        hit = (idx_sorted[pos] == cand_i) & later
        cand_k = torch.where(hit, torch.full_like(cand_k, float("-inf")),
                             cand_k)
        allk = torch.cat([cand_k, skey])
        alli = torch.cat([cand_i, idx_prev64])
    else:
        allk, alli = cand_k, cand_i

    tsel = topk_positions(allk, k)
    tv = allk[tsel]
    kth = tv[k - 1]
    valid = kth > float("-inf")
    ok = fits & valid
    if regtopk:
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
                # (a no-op at step 0: the support slots keep their keys)
                fix = torch.where(later, skey, keys[idx_prev64])
                bigvec.scatter_set_(keys, idx_prev64, fix)
            idx_k = topk_positions(keys, k)
            del keys
    values = a[idx_k]
    count = torch.full((), k, dtype=torch.int32, device=a.device)
    p = None if participate is None else participate.reshape(())
    # a's buffer becomes err_prev, and DGC's momentum masking mom' * (1 -
    # s) is the same O(k) scatter-zero; a sitting-out worker's write
    # nothing (err_prev keeps err_decay * err, mom momentum * mom), and
    # its payload is inert
    err = bigvec.scatter_set_live_(a, idx_k, p, 0.0)
    if mom_out is not None:
        bigvec.scatter_set_live_(mom_out, idx_k, p, 0.0)
    if p is not None:
        values = torch.where(p, values, 0.0)
        idx_k = torch.where(p, idx_k, 0)
        count = torch.where(p, count, 0)
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
