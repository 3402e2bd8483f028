"""The readers of the program's own record (``bench/record.py`` and the
metrics ``fwd_ms``, ``bwd_ms``, ``fwd_idle_ms``, ``bwd_idle_ms``,
``host_reads``, ``host_read_ms``, ``sweep2_fill`` and
``sweep2_over_share``) on a hand-built View and record: the values worked
out by hand, None where the program keeps no record (a program without
``repro_torch.trace``) or the record holds nothing of what a reader
reads."""
import json
import sys

import pytest

from bench import spec
from bench.tests.conftest import ROOT
from bench.trace import View

READERS = ("fwd_ms", "bwd_ms", "fwd_idle_ms", "bwd_idle_ms", "host_reads",
           "host_read_ms", "sweep2_fill", "sweep2_over_share")
SHIFT = 1000.0          # the record's clock less the View's, in seconds


def _span(step, name, t0, t1, parent="train/loss_grad", device_ms=None,
          **attrs):
    return {"kind": "span", "name": name, "step": step, "parent": parent,
            "thread": 1, "t0_ns": int(round((t0 + SHIFT) * 1e9)),
            "t1_ns": int(round((t1 + SHIFT) * 1e9)), "attrs": attrs,
            "n": 1, "device_ms": device_ms}


def _count(step, name, n, **attrs):
    return {"kind": "count", "name": name, "step": step,
            "parent": "compress/trim", "thread": 1, "t0_ns": 0, "t1_ns": 0,
            "attrs": attrs, "n": n, "device_ms": None}


def hand_record() -> list:
    """Two steps, at 0 s and 1 s on the View's clock."""
    recs = []
    for step, at, fwd_dev in ((7, 0.0, 100.0), (8, 1.0, 110.0)):
        recs += [
            _span(step, "train/loss_grad", at + 0.1, at + 0.5, "step"),
            _span(step, "model/forward", at + 0.1, at + 0.2,
                  device_ms=fwd_dev),
            _span(step, "model/backward", at + 0.25, at + 0.5,
                  device_ms=2 * fwd_dev)]
    recs += [_count(7, "host_reads", 1, site="trim_ok"),
             _span(7, "compress/trim/read", 0.6, 0.6005, "compress/trim",
                   site="trim_ok"),
             _count(7, "sweep2_max_cnt", 33, bucket=0),
             _count(7, "sweep2_slots", 33, bucket=0),
             _count(7, "sweep2_tiles", 100, bucket=0),
             _count(7, "sweep2_over", 0, bucket=0)]
    recs += [_count(8, "host_reads", 1, site="trim_ok"),
             _count(8, "host_reads", 1, site="trim_fits"),
             _span(8, "compress/trim/read", 1.6, 1.60025, "compress/trim"),
             _span(8, "compress/trim/read", 1.61, 1.61025, "compress/trim")]
    for b, (most, over) in enumerate(((40, 3), (10, 0))):
        recs += [_count(8, "sweep2_max_cnt", most, bucket=b),
                 _count(8, "sweep2_slots", 33, bucket=b),
                 _count(8, "sweep2_tiles", 100, bucket=b),
                 _count(8, "sweep2_over", over, bucket=b)]
    return recs


def hand_view() -> View:
    """Device busy in each step except: 30 and 20 ms inside the forward's
    host span, 50 ms inside the backward's, 40 ms after the step."""
    ops = []
    for at in (0.0, 1.0):
        for s, e in ((0.0, 0.12), (0.15, 0.18), (0.2, 0.3), (0.35, 0.6),
                     (0.64, 1.0)):
            ops.append((at + s, at + e, "k"))
    host = {"bench/batch": [(0.0, 0.05), (1.0, 1.05)],
            "train/loss_grad": [(0.1001, 0.5), (1.1001, 1.5)]}
    return View(2, 2.0, ops, {}, host, {})


@pytest.fixture
def record(monkeypatch):
    from repro_torch import trace
    recs = hand_record()
    monkeypatch.setattr(trace, "step_ids", lambda: [5, 7, 8])
    monkeypatch.setattr(trace, "records", lambda steps=None: [
        r for r in recs if steps is None or r["step"] in steps])
    return recs


def readers() -> dict:
    return {name: spec.load_reader(ROOT, name) for name in READERS}


def test_each_reader_on_a_hand_built_view(record):
    got = {name: r.read(hand_view()) for name, r in readers().items()}
    want = {"fwd_ms": 105.0, "bwd_ms": 210.0, "fwd_idle_ms": 50.0,
            "bwd_idle_ms": 50.0, "host_reads": 1.5, "host_read_ms": 0.5,
            "sweep2_fill": (100.0 + 100.0 * 40 / 33) / 2,
            "sweep2_over_share": (0.0 + 1.5) / 2}
    assert got == pytest.approx(want)


def test_the_steps_read_are_the_views_last(record):
    """A View of one traced step reads the record's last step alone."""
    view = hand_view()
    view.steps = 1
    r = readers()
    assert r["host_reads"].read(view) == 2.0
    assert r["fwd_ms"].read(view) == 110.0
    assert r["sweep2_fill"].read(view) == pytest.approx(100.0 * 40 / 33)


def test_none_without_a_record(monkeypatch):
    from repro_torch import trace
    monkeypatch.setattr(trace, "step_ids", lambda: [])
    for name, reader in readers().items():
        assert reader.read(hand_view()) is None, name


def test_none_where_the_program_keeps_no_record(monkeypatch):
    """A program without ``repro_torch.trace`` (the benchmark's files laid
    over an older program) reads None and raises nothing."""
    import repro_torch
    monkeypatch.delattr(repro_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    for name, reader in readers().items():
        assert reader.read(hand_view()) is None, name


def test_none_where_the_record_lacks_what_is_read(monkeypatch):
    """No device events (a CPU run), no spans of the model, no sweep 2
    counters: the readers of them read None; counts of nothing read 0."""
    from repro_torch import trace
    recs = [_span(7, "train/loss_grad", 0.1, 0.5, "step")]
    monkeypatch.setattr(trace, "step_ids", lambda: [7])
    monkeypatch.setattr(trace, "records", lambda steps=None: recs)
    got = {name: r.read(hand_view()) for name, r in readers().items()}
    assert got == {"fwd_ms": None, "bwd_ms": None, "fwd_idle_ms": None,
                   "bwd_idle_ms": None, "host_reads": 0.0,
                   "host_read_ms": 0.0, "sweep2_fill": None,
                   "sweep2_over_share": None}


def test_the_entries_match_their_readers():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in b["per_layer"]}
    for name, reader in readers().items():
        assert entries[name]["unit"] == reader.UNIT
        assert entries[name]["moves"] == reader.MOVES
