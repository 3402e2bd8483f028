"""Deterministic fault-injection schedules for elastic aggregation (the
port of the participation half of ``repro.core.faults``).

A :class:`FaultSchedule` decides, per (step, worker), whether that
worker takes part in the step's gradient sync. The decision is a pure,
seeded function of (schedule, step, worker), so every rank evaluating
its own bit agrees with every replay of the schedule, and the reference
and the port draw the same bits.

Three schedule kinds (the spec strings of ``--fault-schedule``):

- ``iid:<p>[,seed=<s>]``: every worker independently drops each step
  with probability p (threefry draws, ``core.threefry``).
- ``bursty:period=<P>,outage=<O>[,workers=<i+j+...>]``: the listed
  workers (default worker 0) sit out the first O steps of every P-step
  window.
- ``permanent:step=<t>[,workers=<i+j+...>]``: the listed workers
  (default worker 0) drop at step t and never return.

The train step evaluates :func:`participates` on the card from its step
counter, with no host read; ``core.aggregate`` then masks a sitting-out
worker's payload inert and decays its error feedback
(``SparsifierConfig.err_decay``).

The second half holds the delta broadcast's channel schedules
(``serve.delta``): a :class:`ChannelFaultSchedule` decides, per published
``param_version``, whether the trainer-to-replica channel drops that
payload (``loss:p``), flips a bit of it in flight (``corrupt:p``),
delivers it late (``reorder:window``) or holds it back with the rest of a
stall window (``stall:steps``). Those too are pure seeded functions of
(schedule, version), drawn as the reference draws them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.numerics import f32

KINDS = ("iid", "bursty", "permanent")


@dataclass(frozen=True)
class FaultSchedule:
    kind: str                   # "iid" | "bursty" | "permanent"
    drop_prob: float = 0.0      # iid: per-(step, worker) drop probability
    period: int = 0             # bursty: window length in steps
    outage: int = 0             # bursty: down-steps per window
    fail_step: int = 0          # permanent: first dead step
    workers: tuple = (0,)       # bursty/permanent: affected worker indices
    seed: int = 0               # iid: PRNG stream seed


def parse_schedule(spec: str) -> Optional[FaultSchedule]:
    """Parse a ``--fault-schedule`` spec; "" and "none" give None.

    Grammar: ``<kind>:<args>`` with comma-separated ``key=value`` args
    (worker lists joined by ``+``: ``workers=1+3``); iid also takes a
    bare leading probability, ``iid:0.3``."""
    spec = (spec or "").strip()
    if not spec or spec == "none":
        return None
    kind, _, rest = spec.partition(":")
    if kind not in KINDS:
        raise ValueError(
            f"unknown fault schedule kind {kind!r} in {spec!r}; "
            f"expected one of {KINDS}")
    kv = {}
    for i, part in enumerate(p for p in rest.split(",") if p):
        if "=" not in part:
            if kind == "iid" and i == 0:
                kv["p"] = part
                continue
            raise ValueError(f"malformed fault schedule arg {part!r} "
                             f"in {spec!r} (want key=value)")
        key, val = part.split("=", 1)
        kv[key.strip()] = val.strip()
    workers = tuple(int(w) for w in kv.get("workers", "0").split("+"))
    if kind == "iid":
        p = float(kv.get("p", kv.get("drop_prob", "0")))
        if not 0.0 <= p < 1.0:
            raise ValueError(f"iid drop probability must be in [0, 1): {p}")
        return FaultSchedule("iid", drop_prob=p, seed=int(kv.get("seed", 0)))
    if kind == "bursty":
        period = int(kv.get("period", 0))
        outage = int(kv.get("outage", 0))
        if period <= 0 or not 0 <= outage <= period:
            raise ValueError(
                f"bursty schedule needs period > 0 and 0 <= outage <= "
                f"period: {spec!r}")
        return FaultSchedule("bursty", period=period, outage=outage,
                             workers=workers)
    fail_step = int(kv.get("step", kv.get("fail_step", 0)))
    return FaultSchedule("permanent", fail_step=fail_step, workers=workers)


def format_schedule(sched: Optional[FaultSchedule]) -> str:
    """Inverse of :func:`parse_schedule` (round-trips through it)."""
    if sched is None:
        return ""
    w = "+".join(str(i) for i in sched.workers)
    if sched.kind == "iid":
        return f"iid:{sched.drop_prob},seed={sched.seed}"
    if sched.kind == "bursty":
        return (f"bursty:period={sched.period},outage={sched.outage},"
                f"workers={w}")
    return f"permanent:step={sched.fail_step},workers={w}"


def participates(sched: Optional[FaultSchedule], step: torch.Tensor,
                 worker: int) -> torch.Tensor:
    """Does ``worker`` take part in the sync at ``step``? ``step`` is a
    0-d integer tensor on any device; returns a 0-d bool tensor on that
    device, computed there (no host read). iid draws
    ``uniform(fold_in(fold_in(PRNGKey(seed), step), worker))`` and keeps
    the worker when it is >= the fp32 drop probability, as the
    reference does."""
    step = step.reshape(())
    if sched is None:
        return torch.ones((), dtype=torch.bool, device=step.device)
    if sched.kind == "iid":
        key = threefry.fold_in(threefry.fold_in(
            threefry.prng_key(sched.seed, step.device), step), worker)
        return threefry.uniform01(key) >= f32(sched.drop_prob)
    step = step.to(torch.int32)
    if worker not in sched.workers:
        return torch.ones((), dtype=torch.bool, device=step.device)
    if sched.kind == "bursty":
        return torch.remainder(step, sched.period) >= sched.outage
    return step < sched.fail_step                        # permanent


def participation_matrix(sched: Optional[FaultSchedule], steps: int,
                         n_workers: int) -> np.ndarray:
    """Host-side replay: (steps, n_workers) bool numpy array of the
    schedule's participation bits."""
    out = np.ones((steps, n_workers), bool)
    for t in range(steps):
        step = torch.tensor(t, dtype=torch.int32)
        for w in range(n_workers):
            out[t, w] = bool(participates(sched, step, w))
    return out


def expected_active(sched: Optional[FaultSchedule], n_workers: int) -> float:
    """Steady-state expected count of participating workers."""
    n = float(n_workers)
    if sched is None:
        return n
    if sched.kind == "iid":
        return n * (1.0 - sched.drop_prob)
    naff = float(len([w for w in sched.workers if 0 <= w < n_workers]))
    if sched.kind == "bursty":
        return n - naff * (sched.outage / float(sched.period))
    return n - naff                                      # permanent


def describe(sched: Optional[FaultSchedule], n_workers: int) -> dict:
    """JSON-serializable record of the fault config."""
    if sched is None:
        return {"schedule": "", "n_active_expected": float(n_workers)}
    return {"schedule": format_schedule(sched),
            "kind": sched.kind,
            "n_active_expected": expected_active(sched, n_workers)}


# ---------------------------------------------------------------------------
# Delta-channel fault schedules
#
# Four kinds (the ``--delta-fault-schedule`` spec strings):
#
# - ``loss:<p>[,seed=<s>]``: each version dropped with probability p
#   (never delivered; the replica sees a version gap).
# - ``corrupt:<p>[,seed=<s>]``: each version bit-flipped in flight with
#   probability p after its checksum was stamped, so the applier's guard
#   drops it (a gap, counted on ``dropped_corrupt``).
# - ``reorder:<window>[,seed=<s>]``: each version delayed by a seeded
#   integer in [0, window] versions.
# - ``stall:<steps>[,every=<P>][,at=<v>]``: the versions inside a stall
#   window are held and flushed in order when it ends. One-shot at
#   version ``at`` (default 1) unless ``every > 0`` makes it periodic.
# ---------------------------------------------------------------------------

CHANNEL_KINDS = ("loss", "corrupt", "reorder", "stall")


@dataclass(frozen=True)
class ChannelFaultSchedule:
    kind: str            # "loss" | "corrupt" | "reorder" | "stall"
    prob: float = 0.0    # loss/corrupt: per-version event probability
    window: int = 0      # reorder: max delivery delay, in versions
    steps: int = 0       # stall: held versions per stall window
    every: int = 0       # stall: window period (0 = one-shot)
    at: int = 1          # stall: first stalled version
    seed: int = 0        # loss/corrupt/reorder: PRNG stream seed


def parse_channel_schedule(spec: str) -> Optional[ChannelFaultSchedule]:
    """Parse a ``--delta-fault-schedule`` spec; "" and "none" give None.

    ``<kind>:<args>`` with comma-separated ``key=value`` args; the first
    arg may be bare (``loss:0.3`` is ``loss:p=0.3``, ``reorder:4`` is
    ``reorder:window=4``, ``stall:10`` is ``stall:steps=10``)."""
    spec = (spec or "").strip()
    if not spec or spec == "none":
        return None
    kind, _, rest = spec.partition(":")
    if kind not in CHANNEL_KINDS:
        raise ValueError(
            f"unknown delta-channel fault kind {kind!r} in {spec!r}; "
            f"expected one of {CHANNEL_KINDS}")
    bare_key = {"loss": "p", "corrupt": "p",
                "reorder": "window", "stall": "steps"}[kind]
    kv = {}
    for i, part in enumerate(p for p in rest.split(",") if p):
        if "=" not in part:
            if i == 0:
                kv[bare_key] = part
                continue
            raise ValueError(f"malformed delta-channel fault arg {part!r} "
                             f"in {spec!r} (want key=value)")
        key, val = part.split("=", 1)
        kv[key.strip()] = val.strip()
    seed = int(kv.get("seed", 0))
    if kind in ("loss", "corrupt"):
        p = float(kv.get("p", kv.get("prob", "0")))
        if not 0.0 <= p < 1.0:
            raise ValueError(f"{kind} probability must be in [0, 1): {p}")
        return ChannelFaultSchedule(kind, prob=p, seed=seed)
    if kind == "reorder":
        window = int(kv.get("window", 0))
        if window < 1:
            raise ValueError(f"reorder window must be >= 1: {spec!r}")
        return ChannelFaultSchedule("reorder", window=window, seed=seed)
    steps = int(kv.get("steps", 0))
    every = int(kv.get("every", 0))
    at = int(kv.get("at", 1))
    if steps < 1 or (every and every < steps):
        raise ValueError(
            f"stall schedule needs steps >= 1 and every in {{0}} ∪ "
            f"[steps, inf): {spec!r}")
    return ChannelFaultSchedule("stall", steps=steps, every=every, at=at)


def format_channel_schedule(sched: Optional[ChannelFaultSchedule]) -> str:
    """Inverse of :func:`parse_channel_schedule` (round-trips)."""
    if sched is None:
        return ""
    if sched.kind in ("loss", "corrupt"):
        return f"{sched.kind}:{sched.prob},seed={sched.seed}"
    if sched.kind == "reorder":
        return f"reorder:{sched.window},seed={sched.seed}"
    return f"stall:{sched.steps},every={sched.every},at={sched.at}"


def _channel_key(sched: ChannelFaultSchedule, version) -> torch.Tensor:
    """fold_in(fold_in(PRNGKey(seed), kind's index), version as int32)."""
    salt = CHANNEL_KINDS.index(sched.kind)
    key = threefry.fold_in(threefry.prng_key(sched.seed), salt)
    return threefry.fold_in(key, torch.tensor(version, dtype=torch.int32))


def channel_drops(sched: Optional[ChannelFaultSchedule],
                  version) -> torch.Tensor:
    """Does the channel drop (never deliver) this version? A 0-d bool."""
    if sched is None or sched.kind != "loss":
        return torch.tensor(False)
    return threefry.uniform01(_channel_key(sched, version)) < f32(sched.prob)


def channel_corrupts(sched: Optional[ChannelFaultSchedule],
                     version) -> torch.Tensor:
    """Does the channel flip a bit of this version's payload in flight
    (after its checksum was stamped, so the applier detects it)?"""
    if sched is None or sched.kind != "corrupt":
        return torch.tensor(False)
    return threefry.uniform01(_channel_key(sched, version)) < f32(sched.prob)


def channel_delay(sched: Optional[ChannelFaultSchedule],
                  version) -> torch.Tensor:
    """The delivery delay, in versions, of this version (0 unless
    reorder): ``jax.random.randint(key, (), 0, window + 1)``. Versions
    are delivered in (version + delay, version) order."""
    if sched is None or sched.kind != "reorder":
        return torch.tensor(0, dtype=torch.int32)
    return threefry.randint(_channel_key(sched, version), 0, sched.window + 1)


def channel_stalled(sched: Optional[ChannelFaultSchedule],
                    version) -> torch.Tensor:
    """Is this version inside a stall window (held, flushed in order when
    the window ends)?"""
    if sched is None or sched.kind != "stall":
        return torch.tensor(False)
    v = torch.tensor(version, dtype=torch.int32)
    if sched.every > 0:
        return (v >= sched.at) & (torch.remainder(v - sched.at, sched.every)
                                  < sched.steps)
    return (v >= sched.at) & (v < sched.at + sched.steps)


def expected_delivery_rate(sched: Optional[ChannelFaultSchedule]) -> float:
    """Steady-state share of published versions the applier accepts at
    first arrival: loss and corrupt remove mass; reorder and stall
    deliver everything eventually (they cost staleness, not versions)."""
    if sched is None:
        return 1.0
    if sched.kind in ("loss", "corrupt"):
        return 1.0 - sched.prob
    return 1.0


def describe_channel(sched: Optional[ChannelFaultSchedule]) -> dict:
    """JSON-serializable record of the channel fault config."""
    if sched is None:
        return {"schedule": "", "delivery_rate_expected": 1.0}
    return {"schedule": format_channel_schedule(sched),
            "kind": sched.kind,
            "delivery_rate_expected": expected_delivery_rate(sched)}
