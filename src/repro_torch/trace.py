"""Spans and counters inside the port's train step.

``span(name, device=False, **attrs)`` and ``count(name, n=1, **attrs)``
are the program's trace points (every stage range of ``train/``,
``compress/``, ``sync/``, ``sketch/`` and ``moe/``, and ``model/``).
Tracing is off unless a ``torch.profiler`` runs on the thread that calls
the train step (read at the start of each step: :func:`begin_step`) or
:func:`enable` turned it on. Off, ``span`` returns one shared no-op
context (one flag read; no ``record_function`` is entered) and ``count``
returns at once. On, a span of a stage (:data:`PROFILED`) enters
``record_function(name)``, so a profiler sees the same ranges, and each
span and counter appends one record to an in-memory ring of the last
:data:`RING_STEPS` steps:

    {"kind": "span" or "count", "name", "step", "parent", "thread",
     "t0_ns", "t1_ns", "attrs", "n" (a counter's amount; 1 for a span),
     "device_ms"}

``step`` is the train step's id (:func:`begin_step`); ``parent`` the
innermost span open on the same thread, or on a thread with none open
(autograd's device thread) the innermost span open on the thread that
began the step, or :data:`ROOT`; ``thread`` the native thread id. The
stamps are ``time.time_ns()``, the clock Kineto stamps a profiler trace
with: a profiler range starts at ``trace_start_ns() + time_range.start``
(in ns) on the same clock. A span with ``device=True`` also records a
pair of CUDA events on the current stream at its ends (when CUDA is in
use); its ``device_ms`` is their elapsed time, read when the record is
read (None otherwise). :func:`write_chrome` writes the record as Chrome
trace-event JSON on that clock.

A ``model/`` span is the record's alone: on the card a kernel belongs to
the innermost profiler range open where it was launched, so a profiler
range of the forward would take its kernels from ``train/loss_grad``'s
device span, and a profiler reading the device's ranges as work would
count it as busy time.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict

import torch
from torch.profiler import record_function

RING_STEPS = 64           # steps the record keeps, oldest dropped first
ROOT = "step"             # the parent of a span opened at a step's top
# the spans a profiler sees: the step's stages
PROFILED = ("train/", "compress/", "sync/", "sketch/", "moe/")

_on = False               # the flag every span and counter reads
_forced = False           # enable()
_step = 0                 # the current step's id
_ring: OrderedDict = OrderedDict()   # step id -> [record]
_lock = threading.Lock()
_local = threading.local()
_step_stack: list = []    # the open spans of the thread that began the step


class _Off:
    """The shared context of a span while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _parent(stack: list) -> str:
    if stack:
        return stack[-1]["name"]
    if _step_stack:
        return _step_stack[-1]["name"]
    return ROOT


def _append(rec: dict) -> None:
    with _lock:
        recs = _ring.get(rec["step"])
        if recs is None:
            recs = _ring[rec["step"]] = []
            while len(_ring) > RING_STEPS:
                _ring.popitem(last=False)
        recs.append(rec)


def _event():
    """A timing CUDA event recorded on the current stream, or None where
    CUDA is not in use."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("rec", "device", "rf", "stack")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.rec = {"kind": "span", "name": name, "step": _step,
                    "parent": None, "thread": None, "t0_ns": None,
                    "t1_ns": None, "attrs": attrs, "n": 1, "_ev": None}
        self.device = device
        self.rf = self.stack = None

    def __enter__(self):
        rec, stack = self.rec, _stack()
        rec["parent"] = _parent(stack)
        rec["thread"] = threading.get_native_id()
        stack.append(rec)
        self.stack = stack
        _append(rec)
        if rec["name"].startswith(PROFILED):
            self.rf = record_function(rec["name"])
        rec["t0_ns"] = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        if self.device:
            rec["_ev"] = (_event(), None)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.device and rec["_ev"][0] is not None:
            rec["_ev"] = (rec["_ev"][0], _event())
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec["t1_ns"] = time.time_ns()
        stack = self.stack
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)
        return False


def span(name: str, device: bool = False, **attrs):
    """A context over one stage of the step: off, the shared no-op
    context; on, a record (with a CUDA event pair when ``device``) and,
    for a stage (:data:`PROFILED`), ``record_function(name)``."""
    if not _on:
        return OFF
    return _Span(name, device, attrs)


def count(name: str, n=1, **attrs) -> None:
    """Add ``n`` to the step's counter ``name`` (one record a call)."""
    if not _on:
        return
    t = time.time_ns()
    _append({"kind": "count", "name": name, "step": _step,
             "parent": _parent(_stack()),
             "thread": threading.get_native_id(), "t0_ns": t, "t1_ns": t,
             "attrs": attrs, "n": n, "_ev": None})


def begin_step() -> int:
    """Start a train step: its id, and tracing on for the step where a
    profiler runs on this thread (its state is the thread's own) or
    :func:`enable` turned it on."""
    global _on, _step, _step_stack
    _step += 1
    _on = _forced or torch._C._autograd._profiler_enabled()
    _step_stack = _stack()
    return _step


def enable() -> None:
    """Trace every step from now on, with or without a profiler."""
    global _on, _forced
    _forced = _on = True


def disable() -> None:
    global _on, _forced
    _forced = _on = False


def enabled() -> bool:
    return _on


def clear() -> None:
    with _lock:
        _ring.clear()


def step_ids() -> list:
    """The ids of the steps the record holds, oldest first."""
    with _lock:
        return list(_ring)


def _device_ms(ev):
    if ev is None or ev[0] is None or ev[1] is None:
        return None
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1])


def records(steps=None) -> list:
    """Copies of the records of ``steps`` (ids; None: every step the
    ring holds), in the order they were opened, each span's
    ``device_ms`` read from its events."""
    with _lock:
        held = [rec for step, recs in _ring.items()
                if steps is None or step in steps for rec in recs]
    out = []
    for rec in held:
        row = {key: val for key, val in rec.items() if key != "_ev"}
        row["attrs"] = dict(rec["attrs"])
        row["device_ms"] = _device_ms(rec["_ev"])
        out.append(row)
    return out


def chrome_events(recs: list) -> dict:
    """Chrome trace-event JSON of ``recs`` (:func:`records`): a span is a
    complete event ("X"), a counter an instant ("i"); ``ts`` in us from
    ``baseTimeNanoseconds``, as a ``torch.profiler`` export writes it, so
    both place an event at the same time of day."""
    base = min((r["t0_ns"] for r in recs), default=0) // 10 ** 9 * 10 ** 9
    pid = os.getpid()
    events = []
    for r in recs:
        args = {"step": r["step"], "parent": r["parent"], **r["attrs"]}
        ev = {"name": r["name"], "cat": "repro_torch", "pid": pid,
              "tid": r["thread"], "ts": (r["t0_ns"] - base) / 1e3}
        if r["kind"] == "span":
            end = r["t1_ns"] if r["t1_ns"] is not None else r["t0_ns"]
            ev.update(ph="X", dur=(end - r["t0_ns"]) / 1e3)
            if r["device_ms"] is not None:
                args["device_ms"] = r["device_ms"]
        else:
            ev.update(ph="i", s="t")
            args["n"] = r["n"]
        ev["args"] = args
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "baseTimeNanoseconds": base}


def write_chrome(path: str, steps=None) -> int:
    """Write the record (of ``steps``; None: all) to ``path`` as Chrome
    trace-event JSON; returns the number of events."""
    doc = chrome_events(records(steps))
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])
