"""The reduction of a traced stretch of the window to what the per-layer
readers read.

The stretch is a few whole steps under ``torch.profiler`` (CPU and CUDA
activity). Its events fall in three kinds:

- device operations: kernels, copies and fills on the card (a
  collective's ``nccl:`` range is not one: its kernel is);
- the device-side spans of the program's stages (``train/*``,
  ``compress/*``, ``sync/*``, ...) and of the benchmark's own
  (``bench/batch``, ``bench/step``, ``bench/sync``);
- the host-side ranges of the same names.

Busy time is the union of the device operations' intervals, so work on
two streams at once counts once. A stage's device time is the busy time
inside the union of its device-side spans. The step's own stages
(``train/*``, after ``bench/batch``) follow one another on the device in
stream order, and autograd launches the backward pass's kernels from a
thread of its own, outside the host range of ``train/loss_grad``: so
the device-side span of each of them is taken to run on to the start of
the next one's. The traced window runs from the first step's
``bench/batch`` to the last step's ``bench/sync`` on the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# the program's stage names (record_function) and the harness's own
STAGE_PREFIXES = ("train/", "compress/", "sync/", "sketch/", "moe/",
                  "bench/")


def is_stage(name: str) -> bool:
    return name.startswith(STAGE_PREFIXES)


def merge(intervals: list) -> list:
    """Sorted disjoint [start, end) intervals covering ``intervals``."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def covered(intervals: list, spans: list) -> float:
    """Length of the part of the merged ``intervals`` inside the merged
    ``spans`` (both sorted and disjoint)."""
    total, i = 0.0, 0
    for s0, s1 in spans:
        while i < len(intervals) and intervals[i][1] <= s0:
            i += 1
        k = i
        while k < len(intervals) and intervals[k][0] < s1:
            total += min(s1, intervals[k][1]) - max(s0, intervals[k][0])
            k += 1
    return total


@dataclass
class View:
    """One traced stretch and the run's counters (times in seconds)."""
    steps: int                              # steps traced
    window_s: float                         # the traced window's length
    ops: list                               # [(start, end, name)] device
    device_spans: dict                      # stage -> [(start, end)]
    host_spans: dict                        # stage -> [(start, end)]
    counters: dict = field(default_factory=dict)
    busy: list = field(default_factory=list)

    def __post_init__(self):
        self.busy = merge([(s, e) for s, e, _ in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def stage_busy_s(self, prefix: str, extra_ops: str = "") -> float:
        """Busy time inside the device spans of the stages named
        ``prefix`` (a whole name, or a prefix ending in "/"), and of the
        device operations whose name holds ``extra_ops``."""
        spans = [iv for name, ivs in self.device_spans.items()
                 if name == prefix or (prefix.endswith("/")
                                       and name.startswith(prefix))
                 for iv in ivs]
        if extra_ops:
            spans += [(s, e) for s, e, name in self.ops if extra_ops in name]
        if not spans:
            return None
        return covered(self.busy, merge(spans))

    def host_s(self, name: str) -> float:
        spans = self.host_spans.get(name)
        if not spans:
            return None
        return sum(e - s for s, e in spans)

    def kernel_s(self, part: str) -> tuple:
        """(seconds, launches) of the device operations whose name holds
        ``part``."""
        hits = [e - s for s, e, name in self.ops if part in name]
        return sum(hits), len(hits)

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for s, e, name in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([name[:120], sec] for name, sec in by.items()),
                      key=lambda r: -r[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle time between device operations inside the traced
        window, by the innermost host stage that held the gap's middle."""
        host = sorted(((s, e, name) for name, ivs in self.host_spans.items()
                       for s, e in ivs), key=lambda r: r[0])
        lo = min((s for s, _, name in host if name == "bench/batch"),
                 default=self.busy[0][0] if self.busy else 0.0)
        hi = lo + self.window_s
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        by: dict = {}
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            g0, g1 = max(g0, lo), min(g1, hi)
            if g1 <= g0:
                continue
            mid = 0.5 * (g0 + g1)
            inner = [(s, name) for s, e, name in host if s <= mid < e]
            name = max(inner)[1] if inner else "outside the stages"
            by[name] = by.get(name, 0.0) + (g1 - g0)
        return sorted(([name, sec] for name, sec in by.items()),
                      key=lambda r: -r[1])[:top]


def view_of(events, steps: int, counters: dict) -> View:
    """The View of ``prof.events()`` (times in microseconds there)."""
    from torch.autograd import DeviceType
    ops, dev_spans, host_spans = [], {}, {}
    for e in events:
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if is_stage(e.name):
                dev_spans.setdefault(e.name, []).append((start, end))
            elif not e.name.startswith("nccl:") and end > start:
                ops.append((start, end, e.name))
        elif is_stage(e.name):
            host_spans.setdefault(e.name, []).append((start, end))
    seq = sorted((s, e, name) for name, ivs in dev_spans.items()
                 for s, e in ivs
                 if name.startswith("train/") or name == "bench/batch")
    for (s, e, name), nxt in zip(seq, seq[1:] + [None]):
        if name != "bench/batch" and nxt is not None and nxt[0] > e:
            spans = dev_spans[name]
            spans[spans.index((s, e))] = (s, nxt[0])
    starts = [s for s, _ in host_spans.get("bench/batch", [])]
    ends = [e for _, e in host_spans.get("bench/sync", [])]
    window = (max(ends) - min(starts)) if starts and ends else 0.0
    return View(steps, window, ops, dev_spans, host_spans, counters)
