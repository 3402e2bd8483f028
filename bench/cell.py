"""One rank's run of a training cell.

Set-up builds the program's training step and state as its launcher
(``repro_torch.launch.train.train``) builds them, on weights the
benchmark draws from the seed on the card, and drives that same object
through its first ``READ_STEPS`` steps by the window's own call and feed,
on batches that all differ. Those steps warm up every shape the window
uses, and the harness reads off them what the reference is held against
(:func:`read_first_steps`). The window then takes steps, each a fresh
batch from the program's ``lm_batch``, the step and
``torch.cuda.synchronize()``, until ``seconds`` have passed; ``trace``
profiles ``TRACE_STEPS`` of them. After the window the peak memory is
read (the program's alone: the peak of the harness's own buffers for
the check is left out), the program's state is freed, and rank 0
follows the first steps with the reference and compares.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from collections import Counter

import torch
import torch.distributed as dist
from torch.profiler import record_function

from bench import checks, traffic
from bench import weights as wts

READ_STEPS = 3          # steps the reference follows
TRACE_AFTER = 2         # window steps before the traced stretch
TRACE_STEPS = 6         # steps traced
COMPARE_CHUNK = 1 << 26  # elements a broadcast of the parameters' check


def run_config(cell, seed: int):
    """The program's RunConfig of a cell, as its launcher would build it
    from the same settings."""
    from repro_torch.configs.base import (OptimizerConfig, RunConfig,
                                          ShapeConfig, SparsifierConfig)
    job = cell.job
    return RunConfig(
        model=cell.parts["family"].port_config(cell.config),
        shape=ShapeConfig(job["name"], job["seq"],
                          job["batch_per_rank"] * job["ranks"], "train"),
        sparsifier=SparsifierConfig(**job["sparsifier"]),
        optimizer=OptimizerConfig(**job["optimizer"]),
        seed=traffic.data_seed(seed))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _slice_leaf_sq(vec: torch.Tensor, lo: int, sizes: list) -> torch.Tensor:
    """Per leaf, the sum of squares of the part of ``vec`` (the flat
    vector's elements [lo, lo + len)) that lies in the leaf."""
    out = torch.zeros(len(sizes), dtype=torch.float64, device=vec.device)
    hi, off = lo + vec.numel(), 0
    for i, size in enumerate(sizes):
        a, b = max(off, lo), min(off + size, hi)
        if a < b:
            out[i] = vec[a - lo:b - lo].float().square().sum(
                dtype=torch.float64)
        off += size
    return out


class Rank:
    """The program's step and state on one rank, and what the run reads
    off them."""

    def __init__(self, cell, seed: int, dev, group, rank: int, world: int):
        from repro_torch.core.aggregate import check_supported
        from repro_torch.models.transformer import check_model
        from repro_torch.train.step import build_train_step, init_train_state
        self.cell, self.dev, self.group = cell, dev, group
        self.rank, self.world = rank, world
        self.peak = 0            # the program's peak before a reset
        self.run = run_config(cell, seed)
        check_supported(self.run.sparsifier)
        check_model(self.run.model)
        self.wseed = traffic.weight_seed(seed)
        self.dseed = traffic.data_seed(seed)
        job = cell.job
        self.rows = job["batch_per_rank"]
        self.seq = job["seq"]
        self.specs = cell.parts["family"].leaf_specs(cell.config)
        self.step = build_train_step(self.run, dev, group)
        self.state = init_train_state(
            self.run, dev, group,
            params=wts.make_weights(self.specs, self.wseed, dev))
        self.sizes = [n for _, _, n in self.layout()]
        self.j = sum(self.sizes)

    def layout(self) -> list:
        from repro_torch.core.flatten import tree_items
        return [(p, leaf, leaf.numel())
                for p, leaf in tree_items(self.state.params)]

    def feed(self, t: int) -> dict:
        """This rank's rows of step t's global batch, drawn by the
        program's ``lm_batch`` as its launcher draws them."""
        from repro_torch.data import lm_batch
        data = lm_batch(self.run.model, self.rows * self.world, self.seq,
                        self.dseed, t, self.dev)
        rows = slice(self.rank * self.rows, (self.rank + 1) * self.rows)
        return {key: val[rows] for key, val in data.items()}

    def check_buffers(self, begin: bool) -> None:
        """Around the harness's own buffers for the check: at the begin
        keep the program's peak so far, at the end (the buffers freed)
        restart the count, so that the peak read after the window is the
        program's alone."""
        if self.dev.type != "cuda":
            return
        if begin:
            self.peak = max(self.peak,
                            torch.cuda.max_memory_allocated(self.dev))
        else:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def program_peak(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return max(self.peak, torch.cuda.max_memory_allocated(self.dev))

    def take(self, t: int):
        """One step as the window takes it: (host ms, the loss tensor)."""
        t0 = time.perf_counter()
        with record_function("bench/batch"):
            data = self.feed(t)
        with record_function("bench/step"):
            self.state, metrics = self.step(self.state, data)
        with record_function("bench/sync"):
            _sync(self.dev)
        return (time.perf_counter() - t0) * 1e3, metrics["loss"]

    def read_first_steps(self) -> dict:
        """Steps 0 .. READ_STEPS - 1 (the set-up's), with what the
        reference is held against: each step's loss, the norms by leaf of
        the first aggregate gradient as Adam got it (its m after one
        step over 1 - b1), with a compressor the norms of the first dense
        gradient (:meth:`first_dense_norms`), and the norms of the
        parameters' change over the steps."""
        out = {"loss": []}
        b1 = self.run.optimizer.b1
        shard = self.state.opt["m"].numel()
        for t in range(READ_STEPS):
            _, loss = self.take(t)
            out["loss"].append(float(loss))
            if t == 0:
                sq = _slice_leaf_sq(self.state.opt["m"], self.rank * shard
                                    if self.world > 1 else 0, self.sizes)
                if self.world > 1:
                    dist.all_reduce(sq, group=self.group)
                out["grad_norms"] = (sq.sqrt() / (1.0 - b1)).tolist()
                dense = self.first_dense_norms()
                if dense is not None:
                    out["dense_grad_norms"] = dense
        self.check_buffers(True)
        w0 = dict(wts.leaf_items(wts.make_weights(self.specs, self.wseed,
                                                  self.dev)))
        norms = []
        for path, leaf, _ in self.layout():
            norms.append(float((leaf.detach() - w0[path]).square().sum(
                dtype=torch.float64)) ** 0.5)
        out["update_norms"] = norms
        del w0
        self.check_buffers(False)
        return out

    def first_dense_norms(self):
        """Norms by leaf of the first dense gradient, the mean over the
        ranks, worked out from each rank's compressor state after one
        step (its kind's ``first_dense_gradient``); None where the state
        keeps none."""
        self.check_buffers(True)
        g0 = self.cell.parts["sparsifier"].first_dense_gradient(
            self.state.ef)
        if g0 is None:
            self.check_buffers(False)
            return None
        if self.world > 1:
            dist.all_reduce(g0, group=self.group)
            g0.mul_(1.0 / self.world)
        sq = _slice_leaf_sq(g0, 0, self.sizes)
        del g0
        self.check_buffers(False)
        return sq.sqrt().tolist()

    def ranks_differing(self) -> int:
        """Ranks whose parameters differ in any bit from rank 0's."""
        differ = torch.zeros(1, device=self.dev)
        for _, leaf, _ in self.layout():
            flat = leaf.detach().reshape(-1)
            for lo in range(0, flat.numel(), COMPARE_CHUNK):
                mine = flat[lo:lo + COMPARE_CHUNK]
                theirs = mine.clone()
                dist.broadcast(theirs, 0, group=self.group)
                if not torch.equal(mine.view(torch.int32),
                                   theirs.view(torch.int32)):
                    differ.fill_(1.0)
        dist.all_reduce(differ, group=self.group)
        return int(differ.item())

    def free(self) -> None:
        self.state = self.step = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def window(r: Rank, seconds: float, trace: bool, first: int) -> dict:
    """Steps from ``first`` on until ``seconds`` have passed on every
    rank (closed loop). With ``trace``, TRACE_STEPS of them after
    TRACE_AFTER run under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    step_ms, losses, traced = [], [], []
    fell, n_traced, reasons = 0, 0, Counter()
    prof = None
    t, start = first, time.perf_counter()
    while True:
        if trace and prof is None and len(step_ms) == TRACE_AFTER:
            acts = [ProfilerActivity.CPU]
            if r.dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        tracing = prof is not None and n_traced < TRACE_STEPS
        before = Counter(r.step.gsync.fallback_reasons)
        ms, loss = r.take(t)
        step_ms.append(ms)
        losses.append(loss)
        traced.append(tracing)
        grew = Counter(r.step.gsync.fallback_reasons) - before
        fell += bool(grew)
        reasons.update(grew)
        if tracing:
            n_traced += 1
            if n_traced == TRACE_STEPS:
                prof.stop()
        t += 1
        done = time.perf_counter() - start >= seconds
        if r.world > 1:
            flag = torch.tensor([float(done)], device=r.dev)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=r.group)
            done = bool(flag.item())
        if done:
            break
    window_s = time.perf_counter() - start
    if prof is not None and n_traced < TRACE_STEPS:
        prof.stop()
    bad = sum(not math.isfinite(float(x)) for x in losses)
    return {"step_ms": step_ms, "window_s": window_s, "bad": bad,
            "fallback_steps": fell, "fallback_reasons": dict(reasons),
            "traced": traced, "n_traced": n_traced, "prof": prof}


def p90(values: list) -> float:
    """The 90th percentile of the steps' times."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def reference_readings(cell, seed: int, world: int, dev, mode: str = "fp32",
                       fault: str = "") -> dict:
    """The reference's readings of the cell's first steps for ``seed``,
    on inputs the benchmark makes again from the seed."""
    from bench.reference.follow import follow
    w = wts.make_weights(cell.parts["family"].leaf_specs(cell.config),
                         traffic.weight_seed(seed), dev)
    rows = cell.job["batch_per_rank"] * world
    batches = [traffic.batch(cell.config["vocab_size"], rows,
                             cell.job["seq"], traffic.data_seed(seed), t,
                             dev) for t in range(READ_STEPS)]
    return follow(cell.config, cell.job, w, batches, world, READ_STEPS,
                  mode, fault, model=cell.parts["model"],
                  sparsifier=cell.parts["ref_sparsifier"],
                  optimizer=cell.parts["optimizer"])


def join(rank: int, world: int, init: str, dev=None) -> tuple:
    """(device, group) of this rank: its card (the CPU where ``dev`` says
    so), and over more than one rank the default process group, joined
    at ``init`` (NCCL on cards, gloo on the CPU)."""
    if dev is None:
        dev = torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if world == 1:
        return dev, None
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank)
    return dev, dist.group.WORLD


def run_rank(cell, seed: int, seconds: float, trace: bool, *, rank: int = 0,
             world: int = 1, init: str = "", dev=None,
             started: float = None) -> dict:
    """One rank's whole run. Returns rank 0's record (None elsewhere):
    {"setup_s", "window" (rank 0's), "step_ms_max" (per step, the
    slowest rank's), "peak_bytes" (the fullest rank's), "busy_s" and
    "window_trace_s" (averaged over the ranks), "view" (rank 0's traced
    View), "values", "where", "prog", "ref"}."""
    from bench.trace import view_of
    dev, group = join(rank, world, init, dev)
    try:
        r = Rank(cell, seed, dev, group, rank, world)
        prog = r.read_first_steps()
        if world > 1:
            dist.barrier(group=group)
        setup_s = time.time() - started if started is not None else None
        win = window(r, seconds, trace, READ_STEPS)
        peak = r.program_peak()
        view = None
        if trace:
            counters = {"window_steps": len(win["step_ms"]),
                        "fallback_steps": win["fallback_steps"], "j": r.j,
                        "k": max(1, int(round(
                            cell.job["sparsifier"]["sparsity"] * r.j))),
                        "config": cell.config, "seq": r.seq,
                        "cards": world}
            untraced = [ms for ms, tr in zip(win["step_ms"], win["traced"])
                        if not tr]
            counters["untraced_s"] = sum(untraced) / 1e3
            counters["untraced_tokens"] = (len(untraced) * r.rows * world
                                           * r.seq)
            view = view_of(win["prof"].events(), win["n_traced"],
                           counters)
        mine = {"step_ms": win["step_ms"], "peak": peak,
                "busy_s": view.busy_s if view else None,
                "window_trace_s": view.window_s if view else None}
        if world > 1:
            prog["ranks_differing"] = r.ranks_differing()
            every = [None] * world
            dist.all_gather_object(every, mine, group=group)
        else:
            every = [mine]
        r.free()
        del r
    finally:
        if world > 1:
            dist.destroy_process_group()
    if rank:
        return None
    rec = {"setup_s": setup_s, "window": win, "view": view, "prog": prog,
           "peak_bytes": max(e["peak"] for e in every),
           "step_ms_max": [max(col) for col in zip(*(e["step_ms"]
                                                     for e in every))]}
    if trace:
        rec["busy_s"] = statistics.mean(e["busy_s"] for e in every)
        rec["window_trace_s"] = statistics.mean(e["window_trace_s"]
                                                for e in every)
    rec["ref"] = reference_readings(cell, seed, world, dev)
    rec["values"], rec["where"] = checks.gaps(prog, rec["ref"])
    return rec
