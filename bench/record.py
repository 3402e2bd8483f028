"""The program's own record of the traced steps (``repro_torch.trace``),
as the per-layer readers of the model's and the compressor's insides
read it.

While a profiler runs, every train step of the program keeps its spans
and counters in a ring of its last steps; the traced stretch of the
window is the last ``view.steps`` steps the ring holds (the window's
untraced steps keep nothing). Each reader averages over those steps and
reads None where the program keeps no such record (a program without
``repro_torch.trace``) or the record holds nothing of what it reads.

The record's stamps are ``time.time_ns()``; the View's are seconds on
the profiler's clock. :func:`on_view_clock` places the record on the
View's clock by the offset between the record's ``train/loss_grad``
starts and the View's host spans of the same stage.
"""
from __future__ import annotations

import bisect
import statistics


def traced(view):
    """(step ids, records) of the view's traced steps, or None."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    ids = trace.step_ids()[-view.steps:] if view.steps else []
    if not ids:
        return None
    return ids, trace.records(set(ids))


def spans(recs: list, name: str) -> list:
    return [r for r in recs if r["kind"] == "span" and r["name"] == name
            and r["t1_ns"] is not None]


def counts(recs: list, name: str) -> list:
    return [r for r in recs if r["kind"] == "count" and r["name"] == name]


def by_step(ids: list, recs: list) -> list:
    """The records of each step, in the order of ``ids``."""
    out = {step: [] for step in ids}
    for r in recs:
        if r["step"] in out:
            out[r["step"]].append(r)
    return [out[step] for step in ids]


def device_ms(view, name: str):
    """Device ms a step of the span ``name`` (its CUDA events)."""
    got = traced(view)
    if got is None:
        return None
    ids, recs = got
    ms = [r["device_ms"] for r in spans(recs, name)]
    if not ms or any(x is None for x in ms):
        return None
    return sum(ms) / len(ids)


def host_ms(view, name: str):
    """Host ms a step in the span ``name``; 0 where the traced steps
    hold none."""
    got = traced(view)
    if got is None:
        return None
    ids, recs = got
    return sum(r["t1_ns"] - r["t0_ns"] for r in spans(recs, name)) \
        / 1e6 / len(ids)


def count_per_step(view, name: str):
    """The counter ``name`` a step; 0 where the traced steps hold
    none."""
    got = traced(view)
    if got is None:
        return None
    ids, recs = got
    return sum(r["n"] for r in counts(recs, name)) / len(ids)


def on_view_clock(view, recs: list):
    """The offset (s) to take from a record's stamp (in s) to place it on
    the View's clock: the median over the traced steps of the record's
    ``train/loss_grad`` start less the View's host span of it; None
    without both."""
    mine = sorted(r["t0_ns"] * 1e-9 for r in spans(recs, "train/loss_grad"))
    theirs = sorted(s for s, _ in view.host_spans.get("train/loss_grad", []))
    if not mine or not theirs:
        return None
    n = min(len(mine), len(theirs))
    return statistics.median(a - b for a, b in zip(mine[-n:], theirs[-n:]))


def idle_ms(view, name: str):
    """Device idle ms a step whose middle lies in the host span of
    ``name``: the gaps between the View's busy intervals inside its
    traced window (from the first ``bench/batch``), each given to the
    record's spans of ``name`` placed on the View's clock."""
    got = traced(view)
    if got is None or view.window_s <= 0:
        return None
    ids, recs = got
    offset = on_view_clock(view, recs)
    mine = spans(recs, name)
    if offset is None or not mine:
        return None
    ivs = sorted((r["t0_ns"] * 1e-9 - offset, r["t1_ns"] * 1e-9 - offset)
                 for r in mine)
    starts = [s for s, _ in ivs]
    lo = min((s for s, _ in view.host_spans.get("bench/batch", [])),
             default=view.busy[0][0] if view.busy else 0.0)
    hi = lo + view.window_s
    edges = [lo] + [x for iv in view.busy for x in iv] + [hi]
    total = 0.0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        g0, g1 = max(g0, lo), min(g1, hi)
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid < ivs[i][1]:
            total += g1 - g0
    return 1e3 * total / len(ids)
