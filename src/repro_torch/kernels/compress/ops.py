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
participation bit. randk is one elementwise pass and an O(k) random
gather, no kernel. Anything else raises before any work
(``core.sparsify.check_supported`` names the ROADMAP item).

Density allocation (``allocation`` "proportional" or "adaptive", the
exact selector) cuts the sweeps by the allocation's segments instead of
the buckets: each segment's sweep 1 histogram gives its own tau at its
own provisioning (its static count, or its cap when adaptive, plus
REGTOP-k's support margin after step 0), its sweep 2 runs at its own
slot count, and the trim becomes per-segment trims and one pack to
exactly k pairs (:func:`_allocated_trim`). Adaptive counts come from the
square mass of each segment's ranked, corrected candidate pool.

Streaming (the reference's ``g_segments``/``stream_bounds``):
:class:`FusedStep` takes the gradient one segment of a partition at a
time, as the backward pass produces it, and sweeps each segment as it
comes (on the allocated path its whole B1 -> tau -> B2 chain);
:meth:`FusedStep.finish` runs what joins the segments. The flat call is
the same object fed the slices of g, so streaming is the flat call bit
for bit, and ``num_buckets`` then only chunks the wire.

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
k finite candidate keys; allocated: fewer than a segment's k_l),
"short_pool" (adaptive: a segment's ranked pool shorter than its cap,
so its moment could miss mass) or "support_tie".
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.core import bigvec
from repro_torch.core.allocate import (DEFAULT_SEGMENTS, adaptive_counts,
                                       allocated_select_dense,
                                       dense_segment_moments,
                                       proportional_counts,
                                       randk_allocated_indices,
                                       segment_bounds, segment_caps,
                                       square_mass)
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


def _tile_stats(cnt: torch.Tensor, most: torch.Tensor, maxpb: int,
                **attrs):
    """While tracing, one sweep 2's tile statistics for the step's
    counters: ((2,) int64 on cnt's device: ``most`` (cnt's largest) and
    the tiles over ``maxpb`` slots, the tiles, maxpb, ``attrs``), read
    with the witnesses (:func:`_host_read`); None while tracing is off."""
    if not trace.enabled():
        return None
    stats = torch.stack([most.to(torch.int64),
                         (cnt > maxpb).sum(dtype=torch.int64)])
    return stats, cnt.numel(), maxpb, attrs


def _host_read(site: str, x: torch.Tensor, tiles=()):
    """``bool(x)`` of a 0-d x, else ``x.tolist()``: a device-to-host read
    of the step. While tracing, it runs in a ``compress/trim/read`` span
    and adds 1 to the step's ``host_reads`` (attribute ``site``), and the
    statistics of ``tiles`` (:func:`_tile_stats`) ride in the same read
    (one stack, one ``.tolist()``) and become the step's counters
    ``sweep2_max_cnt``, ``sweep2_slots``, ``sweep2_tiles`` and
    ``sweep2_over`` (tiles with cnt > maxpb), one each a sweep 2."""
    if not trace.enabled():
        return bool(x) if x.ndim == 0 else x.tolist()
    trace.count("host_reads", site=site)
    n = x.numel()
    tiles = [t for t in tiles if t is not None]
    with trace.span("compress/trim/read", site=site):
        vals = torch.cat([x.reshape(-1).to(torch.int64)]
                         + [t[0] for t in tiles]).tolist()
    for (_, n_tiles, slots, attrs), most, over in zip(
            tiles, vals[n::2], vals[n + 1::2]):
        trace.count("sweep2_max_cnt", most, **attrs)
        trace.count("sweep2_slots", slots, **attrs)
        trace.count("sweep2_tiles", n_tiles, **attrs)
        trace.count("sweep2_over", over, **attrs)
    head = [bool(v) for v in vals[:n]]
    return head[0] if x.ndim == 0 else head


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


def fused_compress_arrays(kind: str, g, err_prev: torch.Tensor,
                          step: torch.Tensor, *, k: int, omega: float = 1.0,
                          mu: float = 0.1, Q: float = 0.0,
                          momentum: float = 0.0, mom=None, idx_prev=None,
                          a_prev_sel=None, g_prev_sel=None, nsel_prev=None,
                          participate=None, err_decay: float = 1.0,
                          num_buckets: int = 1, selector: str = "exact",
                          key=None, allocation: str = "global",
                          seg_bounds=None, g_segments=None,
                          stream_bounds=None) -> dict:
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

    ``allocation`` "proportional" or "adaptive" splits k over the
    segments ``seg_bounds`` ([(offset, size), ...]; the near-equal cut of
    ``allocate.DEFAULT_SEGMENTS`` when None): each segment's sweeps get
    their own threshold and slots, and the trim is per segment
    (:func:`_allocated_trim`). ``g_segments`` (with ``g`` None) feeds the
    gradient as per-segment arrays of the partition ``stream_bounds``,
    which then cuts the sweeps (and must equal ``seg_bounds`` when
    allocated); selection is partition-invariant, so every output is
    the flat call's, bit for bit.

    Returns {"err": next err_prev (J,) of err_prev's dtype, "mom": DGC's
    next momentum or None, "values" fp32, "indices" int32 bits (k, or
    the capacity for the histogram selector), "count" 0-d int32 live
    slots, "fallback" reason or ""}, values ordered by |score|
    descending."""
    if g_segments is None:
        bounds = None
    else:
        if g is not None or stream_bounds is None or \
                len(stream_bounds) != len(g_segments):
            raise ValueError("streaming: pass g_segments and their "
                             "stream_bounds, not a flat g")
        bounds = stream_bounds
    sweeps = FusedStep(
        kind, err_prev, step, k=k, omega=omega, mu=mu, Q=Q,
        momentum=momentum, mom=mom, idx_prev=idx_prev,
        a_prev_sel=a_prev_sel, g_prev_sel=g_prev_sel, nsel_prev=nsel_prev,
        participate=participate, err_decay=err_decay,
        num_buckets=num_buckets, selector=selector, key=key,
        allocation=allocation, seg_bounds=seg_bounds, bounds=bounds)
    for pos, (off, size) in enumerate(sweeps.bounds):
        sweeps.feed(pos, g[off:off + size] if g_segments is None
                    else g_segments[pos])
    return sweeps.finish()


class FusedStep:
    """One fused compression step fed segment by segment: :meth:`feed`
    runs a segment's sweep 1 as soon as its gradient exists (and, when
    allocated, the segment's threshold and sweep 2 too: each segment has
    its own tau), :meth:`finish` runs what joins the segments (the merged
    histogram's tau and the sweep 2s of the global path, the trim, the
    O(k) state writes) and returns :func:`fused_compress_arrays`'s dict.
    The sweeps write into views of (J,) buffers allocated here, so the
    segments may be fed in any order and on another CUDA stream (the
    caller orders the streams). ``bounds``: the sweeps' partition (the
    stream's); by default the allocation's segments, else the buckets."""

    def __init__(self, kind: str, err_prev: torch.Tensor, step: torch.Tensor,
                 *, k: int, omega: float = 1.0, mu: float = 0.1,
                 Q: float = 0.0, momentum: float = 0.0, mom=None,
                 idx_prev=None, a_prev_sel=None, g_prev_sel=None,
                 nsel_prev=None, participate=None, err_decay: float = 1.0,
                 num_buckets: int = 1, selector: str = "exact", key=None,
                 allocation: str = "global", seg_bounds=None, bounds=None):
        if kind not in FUSED_KINDS:
            raise NotImplementedError(
                f"fused kind={kind!r} is not ported (the fused kinds: "
                f"{FUSED_KINDS})")
        j = err_prev.numel()
        # the trace's attribute of a sweep's part: the buckets' index, or
        # the stream's or the allocation's segment
        self.unit = ("bucket" if bounds is None and allocation == "global"
                     else "segment")
        self.kind, self.err_prev, self.step = kind, err_prev, step
        self.k = int(min(k, j))
        self.j = j
        self.allocated = allocation != "global"
        self.allocation = allocation
        if self.allocated:
            if selector != "exact":
                raise ValueError(f"allocation={allocation!r} needs the "
                                 "exact selector")
            seg_bounds = [tuple(b) for b in (seg_bounds or segment_bounds(
                j, DEFAULT_SEGMENTS))]
            if bounds is not None and [tuple(b) for b in bounds] != \
                    seg_bounds:
                raise ValueError("streaming with allocation != 'global' "
                                 "needs the stream partition == seg_bounds")
            bounds = seg_bounds
        elif bounds is None:
            bounds = bucket_bounds(j, num_buckets)
        self.bounds = [tuple(b) for b in bounds]
        if sum(size for _, size in self.bounds) != j or any(
                off != prev_off + prev_size for (off, _), (prev_off,
                                                           prev_size)
                in zip(self.bounds[1:], self.bounds)):
            raise ValueError(f"bounds {self.bounds[:4]}... do not tile "
                             f"[0, {j})")
        self.hist = selector == "histogram" and kind != "randk"
        self.kcap = hist_capacity(self.k, j) if self.hist else self.k
        self.opts = dict(omega=omega, mu=mu, idx_prev=idx_prev,
                         a_prev_sel=a_prev_sel, g_prev_sel=g_prev_sel,
                         nsel_prev=nsel_prev)
        self.mom = mom if kind == "dgc" else None
        self.momentum = momentum
        self.p = None if participate is None else participate.reshape(())
        self.err_decay = err_decay
        self.key = key
        if kind == "randk" and key is None:
            raise ValueError("randk needs a PRNG key")
        dev = err_prev.device
        self.later = step > 0
        self.c = sweep_factor(kind, step, mu=mu, Q=Q)
        self.gate = None if self.p is None else \
            self.p.reshape(1).to(torch.float32)
        n_out = 1 if kind == "randk" else 2 if self.mom is None else 3
        out = [torch.empty(j, dtype=torch.float32, device=dev)
               for _ in range(n_out)]
        self.a = out[0]
        self.score = out[1] if n_out > 1 else None
        self.mom_out = out[2] if n_out > 2 else None
        nseg = len(self.bounds)
        self.fed = [False] * nseg
        self.hists = [None] * nseg
        self.cands = [None] * nseg
        self.tiles = [None] * nseg
        if self.allocated:
            sizes = [size for _, size in self.bounds]
            self.caps = segment_caps(self.k, sizes)
            # slots and trim window a segment: proportional realises its
            # static counts, adaptive may tilt a segment up to its cap
            if allocation == "proportional":
                self.counts_static = proportional_counts(self.k, sizes)
                self.provs = [max(1, n) for n in self.counts_static]
            else:
                self.counts_static = None
                self.provs = self.caps

    def feed(self, pos: int, g_seg: torch.Tensor) -> None:
        """Sweep segment ``pos`` of the partition: g_seg its (size,) fp32
        gradient."""
        if self.fed[pos]:
            raise RuntimeError(f"segment {pos} fed twice")
        off, size = self.bounds[pos]
        if g_seg.numel() != size:
            raise ValueError(f"segment {pos}: {g_seg.numel()} elements, "
                             f"the partition has {size}")
        sl = slice(off, off + size)
        with trace.span("compress/sweeps", **{self.unit: pos}):
            if self.kind == "randk":
                dtype = self.err_prev.dtype
                gs, es = g_seg.to(dtype), self.err_prev[sl]
                if self.p is not None:
                    gs, es = pk.masked_inputs(gs, es, self.p, self.err_decay)
                torch.add(es.float(), gs.float(), out=self.a[sl])
            else:
                self._sweep1(pos, g_seg, sl)
        self.fed[pos] = True

    def _sweep1(self, pos: int, g_seg, sl) -> None:
        """B1 of one segment into the views; allocated: its own tau (the
        histogram tail at its provisioning plus REGTOP-k's support margin
        after step 0) and its B2 at its own slot count."""
        view = [x[sl] for x in (self.a, self.score, self.mom_out)
                if x is not None]
        ms = None if self.mom is None else self.mom[sl]
        if self.gate is None:
            res = pk.sweep1(g_seg, self.err_prev[sl], self.c, ms,
                            self.momentum, out=view)
        else:
            res = pk.sweep1_gated(g_seg, self.err_prev[sl], self.c,
                                  self.gate, self.err_decay, ms,
                                  self.momentum, out=view)
        self.hists[pos] = res[3]
        if not self.allocated:
            return
        off, size = self.bounds[pos]
        prov = self.provs[pos]
        target = prov
        if self.kind == "regtopk":
            # support corrections may drop <= min(k, size) in-segment
            # entries below tau without breaking the segment's cover
            target = prov + self.later.to(torch.int64) * min(self.k, size)
        tau = pk.threshold_from_hist(res[3], target)
        maxpb = int(min(pk.BLOCK, max(32, -(-8 * prov * pk.BLOCK // size))))
        ck, ci, cnt = pk.sweep2(self.score[sl], tau, maxpb)
        most = cnt.max()
        self.cands[pos] = (ck, bigvec.as_index(ci) + off, most <= maxpb)
        self.tiles[pos] = _tile_stats(cnt, most, maxpb, segment=pos)

    def side_outputs(self) -> list:
        """The tensors :meth:`feed` allocated (histograms, candidates), for
        a caller that fed on another stream to mark for the stream that
        finishes (``Tensor.record_stream``)."""
        out = [h for h in self.hists if h is not None]
        for cand in self.cands:
            if cand is not None:
                out.extend(cand)
        out.extend(t[0] for t in self.tiles if t is not None)
        return out

    def finish(self) -> dict:
        if not all(self.fed):
            raise RuntimeError(
                f"segments {[i for i, f in enumerate(self.fed) if not f]} "
                "were never fed")
        if self.kind == "randk":
            with trace.span("compress/trim"):
                return self._randk_tail()
        regtopk = self.kind == "regtopk"
        if self.allocated:
            with trace.span("compress/trim"):
                return _allocated_trim(self, regtopk)
        with trace.span("compress/sweeps"):
            # margin kcap: REGTOP-k support corrections may drop <= kcap
            # entries below tau without breaking top-k coverage of the
            # candidates; the merged histogram is the whole vector's
            target = self.kcap + (self.later.to(torch.int64) * self.kcap
                                  if regtopk else 0)
            tau = pk.threshold_from_bucket_hists(self.hists, target)
            # per-tile slots from the global density, whatever the cut
            maxpb = maxpb_for(self.kcap, self.j)
            cand_k, cand_i, fits, tiles = _sweep2_buckets(
                self.score, tau, maxpb, self.bounds, self.unit)
        with trace.span("compress/trim"):
            return _trim(self.kind, self.a, self.score, cand_k, cand_i, fits,
                         self.later, self.k, self.kcap, step=self.step,
                         mom_out=self.mom_out, participate=self.p,
                         dtype=self.err_prev.dtype, tiles=tiles, **self.opts)

    def _randk_tail(self) -> dict:
        """RANDOM-k after its one elementwise pass: the k positions of
        ``select.randk_indices`` (allocated: each segment's proportional
        count from ``fold_in(key, l)``), the O(k) gather and the O(k)
        scatter-zero of the next state."""
        a, k, p = self.a, self.k, self.p
        if self.allocated:
            idx = randk_allocated_indices(self.key, self.bounds,
                                          self.counts_static or
                                          proportional_counts(
                                              k, [s for _, s in
                                                  self.bounds]))
        else:
            idx = randk_indices(self.key, self.j, k)
        values = a[idx]
        err = bigvec.scatter_set_live_(a.to(self.err_prev.dtype), idx, p,
                                       0.0)
        count = torch.full((), k, dtype=torch.int32, device=a.device)
        if p is not None:
            values = torch.where(p, values, 0.0)
            idx = torch.where(p, idx, 0)
            count = torch.where(p, count, 0)
        return {"err": err, "mom": None, "values": values,
                "indices": bigvec.to_u32_bits(idx), "count": count,
                "fallback": ""}


def _sweep2_buckets(score, tau, maxpb: int, bounds, unit: str = "bucket"):
    """Sweep 2 over each bucket against the global tau: the candidates
    (keys, int64 global indices) in global index order, whether every
    tile's candidates fit its slots (a 0-d bool tensor), and each
    launch's :func:`_tile_stats` (attribute ``unit``: its index)."""
    keys, idx, fits, tiles = [], [], [], []
    for pos, (off, size) in enumerate(bounds):
        ck, ci, cnt = pk.sweep2(score[off:off + size], tau, maxpb)
        most = cnt.max()
        keys.append(ck)
        idx.append(bigvec.as_index(ci) + off)
        fits.append(most <= maxpb)
        tiles.append(_tile_stats(cnt, most, maxpb, **{unit: pos}))
    return (torch.cat(keys), torch.cat(idx), torch.stack(fits).all(),
            tiles)


def _support(a, step, later, *, omega, mu, idx_prev, a_prev_sel,
             g_prev_sel, nsel_prev, cand_i):
    """REGTOP-k's support in candidate space: the corrected support keys,
    the int64 support indices, the live-slot mask (histogram selector),
    and which candidates are support members (whose uncorrected keys the
    caller disables): membership by sort + searchsorted, O((k + cand)
    log k), dead support slots routed to the sentinel J first."""
    j = a.numel()
    idx_prev64 = bigvec.as_index(idx_prev)
    support_valid = None
    if nsel_prev is not None:
        support_valid = (torch.arange(idx_prev64.numel(), device=a.device)
                         < nsel_prev)
    skey = posterior_keys(a[idx_prev64], a_prev_sel, g_prev_sel, step,
                          omega=omega, mu=mu, support_valid=support_valid)
    idx_live = (idx_prev64 if support_valid is None
                else bigvec.live_idx(idx_prev64, support_valid, j))
    idx_sorted = torch.sort(idx_live).values
    hits = []
    for ci in cand_i:
        pos = torch.searchsorted(idx_sorted, ci).clamp(
            max=idx_sorted.numel() - 1)
        hits.append((idx_sorted[pos] == ci) & later)
    return skey, idx_prev64, support_valid, hits


def _dense_keys(score, skey, idx_prev64, support_valid, later):
    """The fallback's dense keys: |score| with the corrected support keys
    written in (a no-op at step 0 and at dead slots, which keep keys)."""
    keys = score.abs()
    if skey is not None:
        live = later if support_valid is None else later & support_valid
        fix = torch.where(live, skey, keys[idx_prev64])
        bigvec.scatter_set_live_(keys, idx_prev64, support_valid, fix)
    return keys


def _trim(kind, a, score, cand_k, cand_i, fits, later, k, kcap, *, omega,
          mu, step, idx_prev, a_prev_sel, g_prev_sel, nsel_prev, mom_out,
          participate, dtype, tiles=()) -> dict:
    """O(candidates) trim to kcap entries (k for the exact selector), the
    exactness witnesses, the fallback and the O(k) state writes of
    :func:`fused_compress_arrays`. The fallback ranks the dense keys of
    ``score``; its values are read from ``a``, which holds the bits the
    reference's fallback recomputes at the support (err + mom' for DGC,
    err + g otherwise, with the bf16 read's roundings). ``tiles``: the
    sweep 2s' statistics, read with the witnesses while tracing."""
    regtopk = kind == "regtopk"
    hist = kcap != k
    skey = idx_prev64 = support_valid = None
    if regtopk:
        skey, idx_prev64, support_valid, (hit,) = _support(
            a, step, later, omega=omega, mu=mu, idx_prev=idx_prev,
            a_prev_sel=a_prev_sel, g_prev_sel=g_prev_sel,
            nsel_prev=nsel_prev, cand_i=[cand_i])
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
    if not _host_read("trim_ok", ok, tiles):  # host read of the witnesses
        fallback = ("overflow" if not _host_read("trim_fits", fits) else
                    "no_kth" if not _host_read("trim_valid", valid) else
                    "support_tie")
    if not fallback:
        idx_k = alli[tsel]
    else:
        with trace.span("compress/fallback"):
            keys = _dense_keys(score, skey, idx_prev64, support_valid, later)
            idx_k = topk_positions(keys, kcap)
            if hist:
                tv = keys[idx_k]
                tau = pk.key_bin_edge(tv[k - 1])
            del keys
    p = None if participate is None else participate.reshape(())
    # a selected entry's value, gathered before a's buffer is cast and
    # zeroed (slots of empty candidates point past J: clamped, then
    # masked out below)
    values = a[idx_k.clamp(max=a.numel() - 1)]
    if not hist:
        return _exact_tail(a, idx_k, values, mom_out, p, k, dtype, fallback)
    live = tv >= tau
    if p is not None:
        live = live & p
    values = torch.where(live, values, 0.0)
    idx_k = torch.where(live, idx_k, 0)
    count = live.sum(dtype=torch.int32)
    # dead slots (pads, a sitting-out worker) write nothing
    err = bigvec.scatter_set_live_(a.to(dtype), idx_k, live, 0.0)
    if mom_out is not None:
        mom_out = bigvec.scatter_set_live_(mom_out.to(dtype), idx_k, live,
                                           0.0)
    return {"err": err, "mom": mom_out, "values": values,
            "indices": bigvec.to_u32_bits(idx_k), "count": count,
            "fallback": fallback}


def _exact_tail(a, idx_k, values, mom_out, p, k: int, dtype,
                fallback: str) -> dict:
    """The O(k) state writes of an exact-k selection: the next err_prev
    is a cast to the state's dtype (a's own buffer when that is fp32)
    with the selected slots zeroed, DGC's momentum masking mom' * (1 - s)
    the same scatter-zero; a sitting-out worker writes nothing and ships
    an inert payload."""
    count = torch.full((), k, dtype=torch.int32, device=a.device)
    if p is not None:
        values = torch.where(p, values, 0.0)
        count = torch.where(p, count, 0)
    err = bigvec.scatter_set_live_(a.to(dtype), idx_k, p, 0.0)
    if mom_out is not None:
        mom_out = bigvec.scatter_set_live_(mom_out.to(dtype), idx_k, p, 0.0)
    if p is not None:
        idx_k = torch.where(p, idx_k, 0)
    return {"err": err, "mom": mom_out, "values": values,
            "indices": bigvec.to_u32_bits(idx_k), "count": count,
            "fallback": fallback}


def _allocated_trim(st: FusedStep, regtopk: bool) -> dict:
    """The per-segment trims and the pack of an allocated step (the
    reference's ``_fused_allocated`` after its sweeps).

    1. REGTOP-k: support members' candidate keys disabled, each support
       entry appended to its own segment with its corrected key;
    2. phase A, per segment: the top-``trim_cap`` of its pool in
       ``lax.top_k`` order, its values read from a, and (adaptive) the
       square mass of that ranking, from which the counts are split on
       the host (one read of S moments);
    3. phase B, per segment: the leading k_l live, with the witnesses:
       every tile fitted its slots, the k_l-th key is finite, the ranked
       pool was not shorter than the statistic's window (adaptive), and
       no boundary tie involves a corrected support key;
    4. one top-k over the live entries packs exactly k pairs (key desc,
       ties segment-major, index ascending).

    A failed witness takes the dense fallback, which is the reference
    pipeline's allocated selector over the dense keys (adaptive counts
    recomputed from the dense moments); ``fallback`` names the reason:
    "overflow", "short_pool", "no_kth" or "support_tie"."""
    a, k, j = st.a, st.k, st.j
    sizes = [size for _, size in st.bounds]
    trim_caps = st.caps if st.counts_static is None else st.provs
    fits = torch.stack([c[2] for c in st.cands]).all()
    ck_parts = [c[0] for c in st.cands]
    ci_parts = [c[1] for c in st.cands]
    skey = idx_prev64 = None
    if regtopk:
        skey, idx_prev64, _, hits = _support(
            a, st.step, st.later, cand_i=ci_parts, **st.opts)
        ck_parts = [torch.where(hit, float("-inf"), ck)
                    for hit, ck in zip(hits, ck_parts)]
    seg_trims, moments, short = [], [], False
    for (off, size), cap, allk, alli in zip(st.bounds, trim_caps, ck_parts,
                                            ci_parts):
        if regtopk:
            in_seg = (idx_prev64 >= off) & (idx_prev64 < off + size)
            allk = torch.cat([allk, torch.where(in_seg, skey,
                                                float("-inf"))])
            alli = torch.cat([alli, idx_prev64])
        eff = max(1, int(min(cap, allk.numel())))
        tsel = topk_positions(allk, eff)
        tv, isel = allk[tsel], alli[tsel]
        seg_trims.append((allk, tv, isel, a[isel.clamp(max=j - 1)], eff))
        if st.allocation == "adaptive":
            moments.append(square_mass(tv))
            # a pool shorter than the statistic's window cannot hold the
            # whole top-cap mass
            short = short or eff < cap
    counts = (adaptive_counts(k, sizes, torch.stack(moments), caps=st.caps)
              if st.allocation == "adaptive" else st.counts_static)
    # witnesses by reason, in the order a reason is named
    held = {"overflow": True, "short_pool": not short, "no_kth": True,
            "support_tie": True}
    names, flags = ["overflow"], [fits]
    packk, packi, packv = [], [], []
    for (allk, tv, isel, vsel, eff), kl in zip(seg_trims, counts):
        if kl <= 0:
            continue
        held["no_kth"] &= kl <= eff
        kth = tv[min(kl, eff) - 1]
        names.append("no_kth")
        flags.append(kth > float("-inf"))
        if regtopk:
            # a boundary tie involving a corrected support key (appended
            # out of index order) with more ties than slots is ambiguous
            n_gt = (allk > kth).sum()
            n_eq = (allk == kth).sum()
            support_tie = (allk[-idx_prev64.numel():] == kth).any()
            names.append("support_tie")
            flags.append((n_eq == kl - n_gt) | ~support_tie)
        packk.append(tv[:kl])
        packi.append(isel[:kl])
        packv.append(vsel[:kl])
    # host read of the witnesses
    for name, good in zip(names, _host_read("allocated_witnesses",
                                            torch.stack(flags), st.tiles)):
        held[name] &= good
    fallback = next((name for name, good in held.items() if not good), "")
    if not fallback:
        sel = topk_positions(torch.cat(packk), k)
        idx_k, values = torch.cat(packi)[sel], torch.cat(packv)[sel]
    else:
        with trace.span("compress/fallback"):
            keys = _dense_keys(st.score, skey, idx_prev64, None, st.later)
            if st.allocation == "adaptive":
                counts = adaptive_counts(
                    k, sizes, dense_segment_moments(keys, st.bounds,
                                                    st.caps), caps=st.caps)
            idx_k = allocated_select_dense(keys, st.bounds, st.caps, counts,
                                           k)
            del keys
        values = a[idx_k]
    return _exact_tail(a, idx_k, values, st.mom_out, st.p, k,
                       st.err_prev.dtype, fallback)


def fused_sketch_encode(g: torch.Tensor, err_prev: torch.Tensor, *,
                        rows: int, width: int, tables: dict | None = None,
                        participate=None, err_decay: float = 1.0) -> dict:
    """The per-worker half of kind="sketchtopk" on the fused pipeline:
    a = err_prev + g and its (rows, width) CountSketch in one pass over
    g and err_prev (kernel ``sweep1_sketch``, which keeps its start
    tables in the caller's ``tables``; its bf16 read for a bf16
    err_prev). ``participate`` (a 0-d bool) masks the inputs as the
    reference's ``masked_inputs`` does, inside the kernel's pass
    (``sweep1_sketch_gated``): a sitting-out worker encodes its decayed
    error. Returns {"a": (J,) fp32, "sketch": (rows, width) fp32}."""
    if participate is None:
        a, sk = pk.sweep1_sketch(g, err_prev, rows, width, tables)
    else:
        gate = participate.reshape(1).to(torch.float32)
        a, sk = pk.sweep1_sketch_gated(g, err_prev, gate, err_decay, rows,
                                       width, tables)
    return {"a": a, "sketch": sk}
