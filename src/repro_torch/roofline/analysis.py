"""Three-term roofline of a dry-run record, and the bucket auto-tune (the
port of ``repro.roofline.analysis``), on the H100's constants.

Terms per (arch x shape x mesh), all in seconds:

  compute    = flops / peak_FLOP/s
  memory     = bytes / HBM_bw
  collective = collective wire bytes / link_bw

The record's counts are one rank's program (``launch.dryrun`` traces
rank 0 of the mesh), so the compute and memory terms divide by one card,
and the collective bytes are one rank's wire bytes. ``model_flops``
uses the 6*N*D training rule (2*N*D a token forward for prefill and
decode) with N the active parameters.

The constants are the card's, written out so that the auto-tune is
deterministic in its inputs: the data sheet's dense bf16 rate, HBM rate
and NVLink 4 rate a direction of an H100 SXM, and a collective's launch
floor measured on four of them (``COLLECTIVE_LATENCY_S``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops_bf16: float      # a card's dense bf16 rate, FLOP/s
    hbm_bw: float               # bytes/s a card
    link_bw: float              # bytes/s a card, one direction of its link


# NVIDIA H100 SXM data sheet (700 W): 989.4 TFLOP/s dense bf16, 3.35 TB/s
# HBM3, NVLink 4 at 450 GB/s a direction
HW_H100 = Hardware("nvidia-h100-sxm", 989.4e12, 3.35e12, 450e9)

# The launch floor of one collective: below it, splitting a collective
# into more chunks costs more in launches than the pipelined overlap
# recovers. The median of 50 CUDA-event timings of one MIN_CHUNK_BYTES
# (64 KiB gathered) NCCL all-gather over four NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit, each after a barrier: 0.08499 ms (chip_smoke.py
# --world 4, line world_allgather; 0.0521 ms each back to back).
COLLECTIVE_LATENCY_S = 84.99e-6
# A chunk below this wire size is latency-dominated: never split finer.
MIN_CHUNK_BYTES = 1 << 16
# Past ~16 chunks the overlap model's min/B term is already flat.
MAX_AUTO_BUCKETS = 16


def auto_num_buckets(packed_len: int, n_workers: int,
                     hw: Hardware = HW_H100, latency_s: float = None,
                     max_buckets: int = MAX_AUTO_BUCKETS) -> int:
    """Auto-tuned bucket count for the chunked sparse-comm schedule.

    The bucketed all-gather pipelines each chunk's collective against
    the previous chunk's local scatter-add combine; with B chunks the
    exposed time is

        exposed(B) ~= max(t_coll, t_combine) + min(t_coll, t_combine)/B
                      + (B - 1) * latency_s

    where t_coll = payload / link_bw (wire) and t_combine = payload /
    hbm_bw (the combine's landing traffic) over the gathered payload
    n_workers * packed_len * 8 bytes (fp32 values and uint32 indices a
    rank). Minimising over B gives B* = sqrt(min(t_coll, t_combine) /
    latency_s), clamped so that every chunk stays above MIN_CHUNK_BYTES
    and B <= max_buckets. ``latency_s`` None reads
    ``COLLECTIVE_LATENCY_S``. Small payloads resolve to 1.

    Deterministic in its inputs: ``num_buckets=0`` and a written-out
    ``num_buckets=auto_num_buckets(...)`` run the same bits (bucketing
    never changes the selection)."""
    if latency_s is None:
        latency_s = COLLECTIVE_LATENCY_S
    payload = max(0, int(n_workers)) * max(0, int(packed_len)) * 8
    if payload <= 0 or latency_s <= 0:
        return 1
    short = min(payload / hw.link_bw, payload / hw.hbm_bw)
    if short <= latency_s:
        return 1
    b = int(math.sqrt(short / latency_s))
    b = min(b, max(1, payload // MIN_CHUNK_BYTES), int(max_buckets))
    return max(1, b)


def model_flops(kind: str, active_params: int, global_batch: int,
                seq_len: int) -> float:
    """Useful model FLOPs of the whole step (all cards)."""
    if kind == "train":
        return 6.0 * active_params * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * active_params * global_batch * seq_len
    return 2.0 * active_params * global_batch      # decode: one token


def pipelined_overlap_s(t_coll: float, t_local: float,
                        num_buckets: int = 1) -> float:
    """Exposed time of a collective pipelined against local work in
    ``num_buckets`` balanced chunks: max(t_coll, t_local) + min(t_coll,
    t_local) / B (one chunk of the shorter side sticks out at the head);
    B = 1 is the serial t_coll + t_local."""
    b = max(1, int(num_buckets))
    return max(t_coll, t_local) + min(t_coll, t_local) / b


def comm_behind_backward_s(t_gather: float, t_backward: float,
                           num_segments: int = 1) -> float:
    """The exposed share of the sparse collective under streaming
    compression (``overlap="backward"``): the gather's overhang past the
    backward pass plus one segment's head, max(0, t_gather - t_backward)
    + min(t_gather, t_backward) / S. S = 1 is the serial t_gather."""
    s = max(1, int(num_segments))
    return max(0.0, t_gather - t_backward) + min(t_gather, t_backward) / s


def roofline_terms(rec: dict, hw: Hardware = HW_H100) -> dict:
    """The three terms of one dry-run record, its dominant term, the
    step-time lower bound and the useful-FLOPs ratio, and the
    reference's diagnostic terms where the record carries their inputs:
    ``collective_exposed_s`` (``num_buckets`` > 1: the sparse gather
    pipelined against its scatter-add combine), the comm-behind-backward
    view (``overlap == "backward"`` on a train record, t_backward =
    2/3 of the compute term by the 6ND rule), the sketch all-reduce, the
    delta channel and the straggler view (``fault``)."""
    chips = 1
    for v in rec["mesh"].values():
        chips *= v
    flops = rec.get("hlo_flops", rec["flops"])
    hbm = rec.get("hlo_bytes", rec["bytes_accessed"])
    wire = rec.get("hlo_collective_wire_bytes",
                   rec["collective_bytes"]["total"])
    t_compute = flops / hw.peak_flops_bf16
    t_memory = hbm / hw.hbm_bw
    t_coll = wire / hw.link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["kind"], rec["active_params"],
                     rec_global_batch(rec), rec_seq_len(rec))
    hlo_total_flops = flops * chips
    terms.update({
        "dominant": dominant.replace("_s", ""),
        "chips": chips,
        "model_flops": mf,
        "hlo_flops_total": hlo_total_flops,
        "useful_ratio": mf / hlo_total_flops if hlo_total_flops > 0 else 0.0,
        "step_time_lb_s": max(t_compute, t_memory, t_coll),
        "mfu_upper_bound": (mf / chips / hw.peak_flops_bf16) /
                           max(t_compute, t_memory, t_coll, 1e-12),
    })
    num_buckets = int(rec.get("num_buckets", 1))
    if num_buckets > 1:
        # only the sparse gradient all-gather is chunked; without the
        # record's own share the whole wire is an upper bound
        gw = rec.get("sparse_gather_wire_bytes", wire)
        t_gather = gw / hw.link_bw
        t_combine = min(t_memory, gw / hw.hbm_bw)
        terms["collective_exposed_s"] = (t_coll - t_gather) + \
            pipelined_overlap_s(t_gather, t_combine, num_buckets)
        terms["num_buckets"] = num_buckets
    if rec.get("overlap") == "backward" and rec.get("kind") == "train":
        num_segments = int(rec.get("num_stream_segments", 1))
        gw = rec.get("sparse_gather_wire_bytes", wire)
        t_gather = gw / hw.link_bw
        t_bwd = (2.0 / 3.0) * t_compute      # 6ND rule: backward = 4ND/6ND
        exposed = comm_behind_backward_s(t_gather, t_bwd, num_segments)
        terms["num_stream_segments"] = num_segments
        terms["backward_overlap_s"] = t_gather - exposed
        terms["collective_exposed_backward_s"] = (t_coll - t_gather) + exposed
    skb = rec.get("sketch_allreduce_bytes")
    if skb:
        # a pre-selection barrier: exposed serially beside the
        # values-only gather
        t_sketch = skb / hw.link_bw
        terms["sketch_allreduce_s"] = t_sketch
        gw = rec.get("sparse_gather_wire_bytes")
        if gw is not None:
            terms["coordinated_collective_s"] = t_sketch + gw / hw.link_bw
    delta = rec.get("delta")
    if delta:
        # learning while serving: per version a sparse broadcast on the
        # wire and an O(k) scatter in HBM (16 bytes an entry); a gap
        # costs a snapshot resync
        k = int(delta.get("k", 0))
        wire = float(delta.get("wire_bytes", 0))
        terms["delta_wire_bytes"] = wire
        terms["delta_bcast_s"] = wire / hw.link_bw
        terms["delta_apply_s"] = (16.0 * k) / hw.hbm_bw
        rs = float(delta.get("resync_bytes", 0))
        terms["resync_bytes"] = rs
        terms["resync_s"] = rs / hw.link_bw
        if delta.get("resync_equiv_deltas") is not None:
            terms["resync_equiv_deltas"] = float(
                delta["resync_equiv_deltas"])
        dfault = delta.get("fault")
        if dfault and wire:
            rate = float(dfault.get("delivery_rate_expected", 1.0))
            terms["delta_delivery_rate"] = rate
            terms["delta_wire_bytes_effective"] = \
                wire + (1.0 - rate) * rs / max(
                    1.0, terms.get("resync_equiv_deltas", 1.0))
    fault = rec.get("fault")
    if fault:
        # the straggler view: absent workers transmit nothing, so the
        # sparse gather shrinks to E[n_active]'s volume; the fixed-shape
        # step does not realise it (inert payloads still move)
        gw = rec.get("sparse_gather_wire_bytes")
        gw_act = fault.get("sparse_gather_wire_bytes_active")
        terms["n_active_expected"] = fault.get("n_active_expected")
        if gw is not None and gw_act is not None:
            t_gather = gw / hw.link_bw
            t_gather_act = gw_act / hw.link_bw
            terms["collective_elastic_s"] = t_coll - t_gather + t_gather_act
            terms["straggler_wire_gain_s"] = t_gather - t_gather_act
    return terms


def rec_global_batch(rec: dict) -> int:
    """The record's global batch: its own where it carries one (a shape
    outside ``SHAPES``, as ``chip_smoke.py`` traces), else its shape's."""
    from repro_torch.configs.base import SHAPES
    return rec.get("global_batch") or SHAPES[rec["shape"]].global_batch


def rec_seq_len(rec: dict) -> int:
    from repro_torch.configs.base import SHAPES
    return rec.get("seq_len") or SHAPES[rec["shape"]].seq_len


def analyze_record(rec: dict, hw: Hardware = HW_H100) -> dict:
    out = dict(rec)
    out["roofline"] = roofline_terms(rec, hw)
    return out


def format_table(records: list, hw: Hardware = HW_H100) -> str:
    """A markdown table of the records' terms."""
    rows = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
        "dominant | useful FLOPs ratio | MFU ub |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for rec in records:
        t = roofline_terms(rec, hw)
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | "
            f"{t['compute_s']*1e3:.2f} | {t['memory_s']*1e3:.2f} | "
            f"{t['collective_s']*1e3:.2f} | {t['dominant']} | "
            f"{t['useful_ratio']:.2f} | {t['mfu_upper_bound']*100:.0f}% |")
    return "\n".join(rows)
