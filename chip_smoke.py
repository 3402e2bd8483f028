#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --train train_sketch_reference [--src OLD/src]
    python3 chip_smoke.py --world 4

The second form runs only the device and build phases and the named
train phases (no profile, no kernels line), from this checkout's port or
from another source tree: an unpacked older commit's ``src/``, so that
two versions can be compared in one run on one card. The third needs
four cards and runs only the multi-card check: one process a card,
joined over NCCL, syncs 3 steps at J = 2^24 of REGTOP-k (fused, sparse
comm) and of dense SGD; g_agg must be bitwise the same on every rank
and, with every rank's state, equal to an in-process ``round()`` of the
same four workers.

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; exits non-zero without either, and when run
outside a checkout of this repository. Phases, each printing one JSON
line and raising on any failure:

1. device:   the card, its power limit, the torch / CUDA / nvcc versions;
2. build:    compiles every kernel of the main path from ``csrc/``;
3. kernels:  each kernel against its plain PyTorch version on the card
             (``torch.equal`` on every output) at the main path's shape
             and at a small ragged shape, with CUDA-event timings;
4. compress: the fused compressor on the card against the same calls on
             CPU copies, bitwise, over 3 REGTOP-k steps and then 3 DGC
             steps (momentum 0.9) at J = 2^24;
5. sketch_sync: sketch-coordinated GradientSync (kind="sketchtopk") at
             J = 2^24, 3 steps, fused pipeline (kernel sweep1_sketch) and
             reference pipeline (kernel sketch_encode), on the card and on
             CPU copies: a bitwise, the sketch within its stated bound,
             then the card's mean sketch decoded on both devices: indices,
             g_agg and the error state bitwise;
6. train:    the port's main path through its launcher: StableLM-3B at
             full width cut to 8 layers, a few REGTOP-k sparse-sync steps,
             with every kernel's launch count read around that run;
7. profile:  one more step of that run under torch.profiler: device time
             by kernel and by stage of the step, and the device busy share
             (the step's new sync builds the sketch path's start table
             again, inside ``sketch/encode``);
8. train_sketch, profile_sketch: the same for the sketchtopk path (fused
             pipeline), after the REGTOP-k run's state is released;
9. reference_sync: GradientSync on the reference pipeline at J = 2^22,
             3 steps, card vs CPU copies bitwise (g_agg and every state
             vector): dense REGTOP-k with the exact selector and sparse
             comm, with the histogram_kernel selector (sparse degrades to
             simulate, one warning), and the O(k) layout with simulate
             comm;
10. train_reference, profile_reference: the reference launcher's default
             config (REGTOP-k, reference pipeline, dense posterior, exact
             selector, simulate comm) through the same launcher, with the
             dense score and apply kernels launched once per step;
11. train_sketch_reference, profile_sketch_reference: the launcher's
             defaults with ``--sparsifier sketchtopk`` (reference
             pipeline, exact selector, simulate comm): the encode
             ``sketch_encode`` and the apply kernel once per step;
12. train_dgc, profile_dgc: DGC (momentum 0.9) on the fused pipeline
             with sparse comm: sweep 1 in its dgc mode (``sweep1_dgc``)
             and sweep 2 once per step;
13. train_dgc_reference, profile_dgc_reference: the launchers' defaults
             with ``--sparsifier dgc`` (reference pipeline, exact
             selector, simulate comm): the momentum update in PyTorch and
             the apply kernel once per step;
14. train_elastic_dgc, profile_elastic_dgc: elastic participation, DGC
             on the fused pipeline with sparse comm, err_decay 0.9 and
             the fault schedule ``bursty:period=3,outage=1,workers=0``
             (the one rank sits out steps 0 and 3): sweep 1's gated
             variant (``sweep1_gated``) and sweep 2 once per step, and
             n_active [0, 1, 1, 0, 1];
15. train_elastic_reference, profile_elastic_reference: the reference
             launcher's defaults under the same schedule and decay: the
             dense score and apply kernels once per step;
16. train_dense, profile_dense: the dense baseline (``--sparsifier
             none``: the dense all-reduce, no kernel), whose stage spans
             are what the other cells' compression shares are stated
             against;
17. train_genie, profile_genie: the genie (``--sparsifier globaltopk``:
             the dense all-reduce, then the top-k over J; no kernel).

Between phases 9 and 10 runs the paper phase (paper_round, paper_fig1,
paper_fig2, paper_genie, paper_fig2_table, paper_fig3, paper): one
``make_round_fn`` round of topk, regtopk and sketchtopk at fig2's shape
(N = 20, J = 100) and fig3's (N = 8, J = 77,370) on the card and on CPU
copies of the same inputs (g_agg and every state bitwise; the sketch
within its bound, then the card's mean sketch decoded on both devices),
then the paper's drivers on the card: fig1, fig2 at S = 0.6 for 1500
iterations, the genie at fig2's size, EXPERIMENTS.md's fig2 table (at
600 iterations, where it has 3000) and fig3 for 150 iterations, held to
the claims of
tests/test_paper_claims.py, with each figure's seconds and launches.

Phase 3 holds sweep 1 in its dgc mode against its plain version too
(kernels_dgc: a, score, amax, hist and mom' with ``torch.equal``, at the
main J and the ragged J), and its gated variant in both modes
(kernels_gated: gate 1 equal to the ungated kernel, gate 0 with decay
0.9 equal to the plain version, bit for bit). Phase 4 also runs 3 fused
steps of each kind under participation (1, 0, 1) with err_decay 0.9.
Phase 3 also holds the two CountSketch encodes (kernels_sketch, B3 and
B4 on the same partitioned passes and one shared start table): B3's a
with ``torch.equal``, both sketches with ``torch.equal`` on dyadic inputs
(every bucket sum exact in any order) and within the per-bucket bound of
``kernel.sketch_error_bound`` on Gaussian inputs, where the card's
atomics add in another order than the plain version, at the ragged J
(widths 512, below the partition width and not a multiple of it, and
beyond the 2^24 buckets a hash reaches; 1 and 3 rows) and at the main
shape; also the start table against the plain one, whether two runs of
each encode give the same bits, the chunks and pair buffer, the time to
build the start table, and each encode's time by kernel. Then the dense
REGTOP-k score and apply (kernels_fused_ef, bit patterns equal, over a
grid of mu, Q and omega with exact zeros of a and zero divisors) and the
linear histogram (kernels_topk_select, counts equal, on Gaussian, zero,
edge, NaN and concentrated inputs and on every bin edge and its fp32
neighbours for four amax values, the floor included; timed beside
``torch.histc`` on the Gaussian and the concentrated input).

After the train phases one line, ``compression_share``, states each
cell against ``train_dense`` from the same run: the profiled step's
compression stages as device ms and as a share of its wall time, and the
median of steps 1-4 over the dense cell's on the host clock, marked
unresolved where it is within the dense cell's own spread. The last three lines are the
per-kernel summary, the card's name and power limit as ``nvidia-smi``
prints them, and the result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: device memory rate, fp32 rate outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SPARSITY = 0.001
MU = 0.5                     # the launcher's default --mu
TRAIN_LAYERS = 8             # StableLM-3B depth cut 32 -> 8, widths unchanged
TRAIN_STEPS = 5
MAIN_J = 892_032_000         # flat J of that model (ModelConfig.param_count)
RAGGED_J = 5 * 4096 + 123
COMPRESS_J = 1 << 24
SKETCH_ROWS = 3
MAIN_WIDTH = 3_568_128       # resolve_width(k = 892,032): 4k, under 2^22
SYNC_STEPS = 3
TIMING_REPS = 10
REF_SYNC_J = 1 << 22
# B3 at widths below the partition width 2^14, not divisible by it, and
# beyond the 2^24 buckets that a hash reaches
SKETCH_EXTRA_WIDTHS = (1000, (1 << 14) + 1, 100_003, (1 << 24) + 1000)
# amax values of B7's edge-neighbour input; 0.0 is floored to f32(1e-30)
HIST_EDGE_AMAX = (1.0, 4.0, 3.7e-3, 0.0)
# (mu, Q, omega) grid of the dense REGTOP-k score kernel
EF_GRID = [(mu, q, w) for mu in (0.1, 0.5) for q in (0.0, 0.3)
           for w in (1.0, 0.125)]
# the reference launcher's default sparsifier (repro.launch.train)
REFERENCE_DEFAULT = dict(kind="regtopk", pipeline="reference",
                         state_format="dense", selector="exact",
                         comm_mode="simulate")
# the same launcher defaults with --sparsifier sketchtopk
SKETCH_REFERENCE = dict(kind="sketchtopk", pipeline="reference",
                        comm_mode="simulate", selector="exact")
# and with --sparsifier dgc
DGC_REFERENCE = dict(kind="dgc", pipeline="reference", comm_mode="simulate",
                     selector="exact")
DGC_MOMENTUM = 0.9           # SparsifierConfig.momentum's default
ERR_DECAY = 0.9              # a sitting-out worker's error-feedback decay
ELASTIC_MASK = (True, False, True)             # phase compress, elastic
# the one rank sits out the first step of every 3: steps 0 and 3 of 5
FAULT_SCHEDULE = "bursty:period=3,outage=1,workers=0"
ELASTIC_ACTIVE = [0.0, 1.0, 1.0, 0.0, 1.0]
SKETCH_TABLE = [[MAIN_J, SKETCH_ROWS, MAIN_WIDTH]]   # (J, rows, width)
FUSED = dict(comm_mode="sparse", pipeline="fused")
# the train phases in run order: sparsifier fields, the kernels that
# each launches once a step (every other kernel 0 times), and the fault
# schedule ("" = every step in)
ELASTIC = dict(err_decay=ERR_DECAY)
TRAIN_PATHS = {
    "train": (dict(kind="regtopk", **FUSED), ("sweep1", "sweep2"), ""),
    "train_sketch": (dict(kind="sketchtopk", **FUSED), ("sweep1_sketch",),
                     ""),
    "train_reference": (REFERENCE_DEFAULT, ("scores", "apply"), ""),
    "train_sketch_reference": (SKETCH_REFERENCE, ("sketch_encode", "apply"),
                               ""),
    "train_dgc": (dict(kind="dgc", **FUSED), ("sweep1_dgc", "sweep2"), ""),
    "train_dgc_reference": (DGC_REFERENCE, ("apply",), ""),
    "train_elastic_dgc": (dict(kind="dgc", **FUSED, **ELASTIC),
                          ("sweep1_gated", "sweep2"), FAULT_SCHEDULE),
    "train_elastic_reference": (dict(REFERENCE_DEFAULT, **ELASTIC),
                                ("scores", "apply"), FAULT_SCHEDULE),
    # the baselines: dense SGD (the dense all-reduce) and the genie (the
    # dense all-reduce, then the top-k over J); no kernel
    "train_dense": (dict(kind="none"), (), ""),
    "train_genie": (dict(kind="globaltopk"), (), ""),
}
# phase paper: the round checks' (workers, J, sparsity), fig2's shape and
# fig3's (the CNN at width 16), and the iterations of each driver run
PAPER_SHAPES = ((20, 100, 0.6), (8, 77_370, 0.001))
PAPER_ROUND_KERNELS = {"topk": ("apply",), "regtopk": ("scores", "apply"),
                       "sketchtopk": ("sketch_encode", "apply")}
FIG1_ITERS = 100
FIG2_ITERS = 1500            # fig2's claims and the genie's
FIG2_TABLE_ITERS = 600       # EXPERIMENTS.md's table (3000 there), cut to
                             # keep the paper phase near two minutes
FIG3_ITERS = 150
KERNEL_META = {
    "sweep1": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
               "src/repro/kernels/compress/kernel.py:78"),
    "sweep1_dgc": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
                   "src/repro/kernels/compress/kernel.py:78"),
    "sweep1_gated": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
                     "src/repro/kernels/compress/kernel.py:78"),
    "sweep2": ("src/repro_torch/kernels/compress/csrc/sweep2.cu",
               "src/repro/kernels/compress/kernel.py:223"),
    "sweep1_sketch": ("src/repro_torch/kernels/compress/csrc/sketch_parts.cu",
                      "src/repro/kernels/compress/kernel.py:335"),
    "sketch_encode": ("src/repro_torch/kernels/compress/csrc/sketch_parts.cu",
                      "src/repro/kernels/compress/kernel.py:321"),
    "scores": ("src/repro_torch/kernels/fused_ef/csrc/fused_ef.cu",
               "src/repro/kernels/fused_ef/kernel.py:29"),
    "apply": ("src/repro_torch/kernels/fused_ef/csrc/fused_ef.cu",
              "src/repro/kernels/fused_ef/kernel.py:47"),
    "histogram": ("src/repro_torch/kernels/topk_select/csrc/hist.cu",
                  "src/repro/kernels/topk_select/kernel.py:31"),
}


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; "t" is the script's elapsed seconds."""
    print(json.dumps({"phase": phase, "t": time.perf_counter() - START,
                      **fields}), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def run_text(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_split_ms(fn) -> dict:
    """Device time by kernel of one call of ``fn`` (after a warm-up),
    from torch.profiler: how a wrapper's time divides among its
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> float:
    import torch
    err = 0.0
    for got, want in pairs:
        if got.is_floating_point():
            d = (got.double() - want.double()).abs()
            d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
            err = max(err, float(d.max()))
        else:
            err = max(err, float((got.long() - want.long()).abs().max()))
    return err


def all_kernels() -> tuple:
    """Every kernel wrapper of the port (each has a ``launches`` count)."""
    from repro_torch.kernels.compress import kernel as pk
    from repro_torch.kernels.fused_ef import kernel as fef
    from repro_torch.kernels.topk_select import kernel as hk
    return pk.KERNELS + fef.KERNELS + hk.KERNELS


def reset_launches() -> None:
    for fn in all_kernels():
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in all_kernels()}


def bits_equal(got, want) -> bool:
    """Equal bit patterns (NaN and the sign of zero included)."""
    import torch
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got, want)


def phase_device() -> str:
    import torch
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    from repro_torch.kernels import build
    nvcc = run_text([build.nvcc_path(), "--version"]).splitlines()[-1]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, log in reports.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def kernel_case(dev, j: int, seed: int, timed: bool) -> dict:
    """Both sweeps at flat length j on seeded inputs, kernel vs plain."""
    import torch
    from repro_torch.core.numerics import regularizer_factor
    from repro_torch.kernels.compress import kernel as pk
    from repro_torch.kernels.compress.ops import maxpb_for
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    c = torch.full((1,), regularizer_factor(0.0, MU), device=dev)
    k = max(1, round(SPARSITY * j))
    out1 = pk.sweep1(g, err, c)
    ref1 = pk.sweep1_plain(g, err, c)
    for name, got, want in zip(("a", "score", "amax", "hist"), out1, ref1):
        check(torch.equal(got, want), f"sweep1 {name} differs at J={j}")
    # tau and MAXPB as a REGTOP-k step after step 0 picks them
    tau = pk.threshold_from_hist(out1[3], 2 * k)
    maxpb = maxpb_for(k, j)
    out2 = pk.sweep2(out1[1], tau, maxpb)
    ref2 = pk.sweep2_plain(out1[1], tau, maxpb)
    for name, got, want in zip(("vals", "idx", "cnt"), out2, ref2):
        check(torch.equal(got, want), f"sweep2 {name} differs at J={j}")
    res = {"j": j, "k": k, "maxpb": maxpb, "tau": float(tau),
           "candidates": int(out2[2].clamp(max=maxpb).sum()),
           "overflow_tiles": int((out2[2] > maxpb).sum()),
           "sweep1_err": max_abs_err(zip(out1, ref1)),
           "sweep2_err": max_abs_err(zip(out2, ref2))}
    if timed:
        rows = pk.rows_of(j)
        res["sweep1_ms"] = cuda_ms(lambda: pk.sweep1(g, err, c))
        res["sweep1_plain_ms"] = cuda_ms(lambda: pk.sweep1_plain(g, err, c))
        res["sweep1_bytes"] = 16 * j + 4 * rows + 4 * pk.BINS
        res["sweep1_ops"] = 4 * j      # add, multiply, abs, max
        res["sweep2_ms"] = cuda_ms(lambda: pk.sweep2(out1[1], tau, maxpb))
        res["sweep2_plain_ms"] = cuda_ms(
            lambda: pk.sweep2_plain(out1[1], tau, maxpb))
        res["sweep2_bytes"] = 4 * j + 8 * rows * maxpb + 4 * rows
        res["sweep2_ops"] = 2 * j      # abs, compare
    return res


def dgc_case(dev, j: int, seed: int, timed: bool) -> dict:
    """Sweep 1 in its dgc mode at flat length j, kernel vs plain: a,
    score, amax, hist and mom' equal. |mom| ~ |g|, so a multiply-add
    rounded twice would differ from the fused one in many elements."""
    import torch
    from repro_torch.kernels.compress import kernel as pk
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    mom = torch.randn(j, generator=gen, device=dev)
    c = torch.ones(1, device=dev)
    out = pk.sweep1_dgc(g, err, mom, c, DGC_MOMENTUM)
    ref = pk.sweep1_plain(g, err, c, mom, DGC_MOMENTUM)
    for name, got, want in zip(("a", "score", "amax", "hist", "mom"),
                               out, ref):
        check(torch.equal(got, want), f"sweep1_dgc {name} differs at J={j}")
    unfused = (mom * DGC_MOMENTUM + g).ne(out[4]).sum()
    res = {"j": j, "momentum": DGC_MOMENTUM,
           "sweep1_dgc_err": max_abs_err(zip(out, ref)),
           "mom_differs_from_two_roundings": int(unfused)}
    del ref
    if timed:
        rows = pk.rows_of(j)
        res["sweep1_dgc_ms"] = cuda_ms(
            lambda: pk.sweep1_dgc(g, err, mom, c, DGC_MOMENTUM))
        res["sweep1_dgc_plain_ms"] = cuda_ms(
            lambda: pk.sweep1_plain(g, err, c, mom, DGC_MOMENTUM))
        # read g, err, mom; write a, score, mom'
        res["sweep1_dgc_bytes"] = 24 * j + 4 * rows + 4 * pk.BINS
        res["sweep1_dgc_ops"] = 6 * j  # fma (2), add, multiply, abs, max
    return res


def gated_case(dev, j: int, seed: int, timed: bool) -> dict:
    """Sweep 1's gated variant in both modes at flat length j: gate 1
    equals the ungated kernel and gate 0 (err_decay 0.9) the plain
    version, every output bit for bit. Every 97th err is -0.0, whose
    decayed value plus a zero must be +0.0."""
    import torch
    from repro_torch.core.numerics import regularizer_factor
    from repro_torch.kernels.compress import kernel as pk
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    err[::97] = -0.0
    mom = torch.randn(j, generator=gen, device=dev)
    on, off = torch.ones(1, device=dev), torch.zeros(1, device=dev)
    res = {"j": j, "decay": ERR_DECAY, "sweep1_gated_err": 0.0}
    for mode in ("plain", "dgc"):
        dgc = mode == "dgc"
        m = mom if dgc else None
        c = torch.full((1,), 1.0 if dgc else regularizer_factor(0.0, MU),
                       device=dev)
        got = pk.sweep1_gated(g, err, c, on, ERR_DECAY, m, DGC_MOMENTUM)
        want = pk.sweep1(g, err, c, m, DGC_MOMENTUM)
        for name, x, y in zip(("a", "score", "amax", "hist", "mom"), got,
                              want):
            check(bits_equal(x, y), f"sweep1_gated {mode} gate 1: {name} "
                  f"differs from the ungated kernel at J={j}")
        del got, want
        got = pk.sweep1_gated(g, err, c, off, ERR_DECAY, m, DGC_MOMENTUM)
        want = pk.sweep1_plain(g, err, c, m, DGC_MOMENTUM, off, ERR_DECAY)
        for name, x, y in zip(("a", "score", "amax", "hist", "mom"), got,
                              want):
            check(bits_equal(x, y), f"sweep1_gated {mode} gate 0: {name} "
                  f"differs from the plain version at J={j}")
        check(not bool(torch.signbit(got[0][::97]).any()),
              "sweep1_gated: -0.0 * decay + 0.0 must be +0.0")
        res["sweep1_gated_err"] = max(res["sweep1_gated_err"],
                                      max_abs_err(zip(got, want)))
        del got, want
    if timed:
        rows = pk.rows_of(j)
        c = torch.ones(1, device=dev)
        res["sweep1_gated_ms"] = cuda_ms(lambda: pk.sweep1_gated(
            g, err, c, on, ERR_DECAY, mom, DGC_MOMENTUM))
        res["sweep1_gated_off_ms"] = cuda_ms(lambda: pk.sweep1_gated(
            g, err, c, off, ERR_DECAY, mom, DGC_MOMENTUM))
        res["sweep1_gated_plain_ms"] = cuda_ms(lambda: pk.sweep1_plain(
            g, err, c, mom, DGC_MOMENTUM, on, ERR_DECAY))
        # the dgc mode's bytes (read g, err, mom; write a, score, mom'),
        # the gate and c
        res["sweep1_gated_bytes"] = 24 * j + 4 * rows + 4 * pk.BINS + 8
        # selects of g, err and mom', decay multiply, fma (2), add,
        # multiply, abs, max
        res["sweep1_gated_ops"] = 10 * j
    return res


def phase_kernels(dev) -> dict:
    import torch
    small = kernel_case(dev, RAGGED_J, seed=1, timed=False)
    emit("kernels_ragged", **small)
    big = kernel_case(dev, MAIN_J, seed=0, timed=True)
    emit("kernels_main_shape", **big)
    torch.cuda.empty_cache()
    dsmall = dgc_case(dev, RAGGED_J, seed=9, timed=False)
    emit("kernels_dgc_ragged", **dsmall)
    dbig = dgc_case(dev, MAIN_J, seed=10, timed=True)
    emit("kernels_dgc_main_shape", **dbig)
    torch.cuda.empty_cache()
    gsmall = gated_case(dev, RAGGED_J, seed=11, timed=False)
    emit("kernels_gated_ragged", **gsmall)
    gbig = gated_case(dev, MAIN_J, seed=12, timed=True)
    emit("kernels_gated_main_shape", **gbig)
    torch.cuda.empty_cache()
    return {"small": small, "big": big, "dgc_small": dsmall, "dgc_big": dbig,
            "gated_small": gsmall, "gated_big": gbig}


def dyadic(gen, j: int, dev):
    """k * 2^-8 with |k| <= 2^10: every partial sum of a bucket is exact
    in fp32, so any order of the atomics gives the sequential sum."""
    import torch
    k = torch.randint(-1024, 1025, (j,), generator=gen, device=dev)
    return k.float() * 2.0 ** -8


def sketch_gap(sk, sk_plain, a) -> tuple[float, float]:
    """(max |sk - sk_plain|, its largest share of the per-bucket bound);
    fails beyond the bound."""
    from repro_torch.kernels.compress import kernel as pk
    rows, width = sk_plain.shape
    bound = pk.sketch_error_bound(a, rows, width).to(sk_plain.device)
    d = (sk.to(sk_plain.device) - sk_plain).abs().double()
    check(bool((d <= bound).all()), "sketch outside its atomics bound")
    share = float((d / bound.clamp(min=1e-300)).max())
    return float(d.max()), share


def sketch_case(dev, j: int, width: int, seed: int, timed: bool,
                rows: int = SKETCH_ROWS) -> dict:
    """Both CountSketch encodes at flat length j, kernel vs plain, on
    dyadic inputs (bitwise) and on Gaussian inputs (a bitwise, the
    sketch within the atomics bound); B3's count kernel against its
    plain table, its plan, and whether two runs give the same bits."""
    import torch
    from repro_torch.kernels.compress import kernel as pk
    gen = torch.Generator(device=dev).manual_seed(seed)
    if not timed:     # the plain table walks every tile: small J only
        starts = pk.sketch_starts(dev, j, rows, width).int() & 0xFFFF
        want = pk.sketch_starts_plain(j, rows, width, device=dev) & 0xFFFF
        check(torch.equal(starts, want.int()),
              f"sweep1_sketch start table differs at J={j}, width={width}")
    tables = {}       # B3's start table of this shape, built at first use
    g, err = dyadic(gen, j, dev), dyadic(gen, j, dev)
    a, sk = pk.sweep1_sketch(g, err, rows, width, tables)
    a_p, sk_p = pk.sweep1_sketch_plain(g, err, rows, width)
    check(torch.equal(a, a_p), f"sweep1_sketch a differs at J={j} (dyadic)")
    check(torch.equal(sk, sk_p), f"sweep1_sketch sketch differs at J={j} "
          "(dyadic)")
    check(torch.equal(pk.sketch_encode(a, rows, width, tables),
                      pk.sketch_encode_plain(a, rows, width)),
          f"sketch_encode differs at J={j} (dyadic)")
    check(len(tables) == 1, "the two encodes share one start table")
    del g, err, a_p, sk, sk_p
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    a, sk = pk.sweep1_sketch(g, err, rows, width, tables)
    a_p, sk_p = pk.sweep1_sketch_plain(g, err, rows, width)
    check(torch.equal(a, a_p), f"sweep1_sketch a differs at J={j}")
    err1, share1 = sketch_gap(sk, sk_p, a_p)
    sk4 = pk.sketch_encode(a, rows, width, tables)
    err4, share4 = sketch_gap(sk4, sk_p, a_p)
    det4 = bits_equal(sk4, pk.sketch_encode(a, rows, width, tables))
    del sk4
    _, sk2 = pk.sweep1_sketch(g, err, rows, width, tables)
    plan = pk.sketch_plan(j, rows, width)
    res = {"j": j, "rows": rows, "width": width, "dyadic_bitwise": True,
           "sweep1_sketch_err": err1, "sweep1_sketch_bound_share": share1,
           "sketch_encode_err": err4, "sketch_encode_bound_share": share4,
           "sweep1_sketch_deterministic": bits_equal(sk, sk2),
           "sketch_encode_deterministic": det4,
           "sweep1_sketch_chunks": plan["nchunks"],
           "sweep1_sketch_parts": plan["parts"],
           "sweep1_sketch_pair_buffer_bytes": plan["pair_bytes"],
           "atomics": rows * j}
    del a_p, sk, sk2, sk_p
    if timed:
        res["sweep1_sketch_ms"] = cuda_ms(
            lambda: pk.sweep1_sketch(g, err, rows, width, tables))
        res["sweep1_sketch_split_ms"] = kernel_split_ms(
            lambda: pk.sweep1_sketch(g, err, rows, width, tables))
        # built once per shape, at a run's first step
        res["sweep1_sketch_table_ms"] = cuda_ms(
            lambda: pk.sketch_starts(dev, j, rows, width))
        res["sweep1_sketch_table_bytes"] = 2 * plan["parts"] * -(
            -j // pk.SKETCH_TILE)
        res["sweep1_sketch_plain_ms"] = cuda_ms(
            lambda: pk.sweep1_sketch_plain(g, err, rows, width))
        res["sweep1_sketch_bytes"] = 12 * j + 4 * rows * width
        res["sweep1_sketch_ops"] = j + rows * j   # add, one add per row
        # the partitioned design's own traffic: g, err, a and the pairs
        # written and read (6 B each)
        res["sweep1_sketch_design_bytes"] = 12 * j + 12 * rows * j
        res["sketch_encode_ms"] = cuda_ms(
            lambda: pk.sketch_encode(a, rows, width, tables))
        res["sketch_encode_split_ms"] = kernel_split_ms(
            lambda: pk.sketch_encode(a, rows, width, tables))
        res["sketch_encode_plain_ms"] = cuda_ms(
            lambda: pk.sketch_encode_plain(a, rows, width))
        res["sketch_encode_bytes"] = 4 * j + 4 * rows * width
        res["sketch_encode_ops"] = rows * j
        # the same design's traffic: a and the pairs written and read
        res["sketch_encode_design_bytes"] = 4 * j + 12 * rows * j
    return res


def phase_kernels_sketch(dev) -> dict:
    import torch
    small = sketch_case(dev, RAGGED_J, 512, seed=3, timed=False)
    emit("kernels_sketch_ragged", **small)
    for i, width in enumerate(SKETCH_EXTRA_WIDTHS):
        for rows in (1, SKETCH_ROWS):
            emit("kernels_sketch_ragged", **sketch_case(
                dev, RAGGED_J, width, seed=20 + i, timed=False, rows=rows))
    big = sketch_case(dev, MAIN_J, MAIN_WIDTH, seed=2, timed=True)
    emit("kernels_sketch_main_shape", **big)
    torch.cuda.empty_cache()
    return {"small": small, "big": big}


def phase_sketch_sync(dev) -> None:
    """GradientSync for kind="sketchtopk" on the card and on CPU copies,
    both pipelines; the card's mean sketch feeds the decode on both."""
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    from repro_torch.kernels.compress import kernel as pk
    cpu = torch.device("cpu")
    for pipeline in ("fused", "reference"):
        cfg = SparsifierConfig(kind="sketchtopk", sparsity=SPARSITY,
                               comm_mode="sparse", pipeline=pipeline,
                               sketch_rows=SKETCH_ROWS)
        sync_d, sync_c = GradientSync(cfg), GradientSync(cfg)
        st_d = sparsify.init_state(cfg, COMPRESS_J, dev)
        st_c = sparsify.init_state(cfg, COMPRESS_J, cpu)
        gen = torch.Generator(device=cpu).manual_seed(11)
        gaps = []
        reset_launches()
        for t in range(SYNC_STEPS):
            g = torch.randn(COMPRESS_J, generator=gen)
            a_d, sk_d = sync_d.encode(st_d, g.to(dev))
            a_c, sk_c = sync_c.encode(st_c, g)
            check(torch.equal(a_d.cpu(), a_c),
                  f"sketch sync {pipeline} step {t}: a differs")
            gaps.append(sketch_gap(sk_d, sk_c, a_c))
            sk_agg = sync_d.allreduce_sketch(sk_d)
            g_d, st_d, idx_d = sync_d.decode_exchange(sk_agg, a_d, st_d)
            g_c, st_c, idx_c = sync_c.decode_exchange(sk_agg.cpu(), a_c,
                                                      st_c)
            key = sparsify.err_key(cfg)
            for name, got, want in (("indices", idx_d, idx_c),
                                    ("g_agg", g_d, g_c),
                                    (key, st_d[key], st_c[key])):
                check(torch.equal(got.cpu(), want),
                      f"sketch sync {pipeline} step {t}: {name} differs "
                      "card vs CPU")
        launches = launch_counts()
        enc = "sweep1_sketch" if pipeline == "fused" else "sketch_encode"
        for name, n in launches.items():
            check(n == (SYNC_STEPS if name == enc else 0),
                  f"sketch sync {pipeline}: {name} launched {n} times")
        emit("sketch_sync", pipeline=pipeline, j=COMPRESS_J,
             steps=SYNC_STEPS, k=sparsify.resolve_k(cfg, COMPRESS_J),
             width=sk_agg.shape[1], launches=launches,
             sketch_err=[e for e, _ in gaps],
             sketch_bound_share=[s_ for _, s_ in gaps],
             decode_bitwise=True)


def ef_inputs(dev, j: int, seed: int):
    """g, err, a_prev, g_agg, s_prev on the card: Gaussian, s_prev 0/1,
    exact zeros of a = err + g (err = -g) and tiny negative a (-1e-13,
    whose safe denominator is 0: a division by zero)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(j, generator=gen, device=dev)
    err = torch.randn(j, generator=gen, device=dev) * 0.1
    a_prev = torch.randn(j, generator=gen, device=dev)
    g_agg = torch.randn(j, generator=gen, device=dev) * 0.5
    s_prev = (torch.rand(j, generator=gen, device=dev) < 0.3).float()
    n = max(4, j // 4096)
    zero = torch.randint(0, j, (n,), generator=gen, device=dev)
    err[zero] = -g[zero]
    tiny = torch.randint(0, j, (n,), generator=gen, device=dev)
    g[tiny], err[tiny] = -1e-13, 0.0
    return g, err, a_prev, g_agg, s_prev


def fused_ef_case(dev, j: int, seed: int, timed: bool) -> dict:
    """B5 (scores) over the (mu, Q, omega) grid and B6 (apply), kernel
    vs plain on the card, bit patterns equal."""
    import torch
    from repro_torch.kernels.fused_ef import kernel as fef
    ins = ef_inputs(dev, j, seed)
    err_s = err_a = 0.0
    zeros = nonfinite = 0
    for mu, q, w in EF_GRID:
        kw = dict(omega=w, mu=mu, Q=q)
        got = fef.scores(*ins, **kw)
        want = fef.scores_plain(*ins, **kw)
        for name, x, y in zip(("a", "score"), got, want):
            check(bits_equal(x, y), f"scores {name} differs at J={j}, "
                  f"mu={mu} Q={q} omega={w}")
        err_s = max(err_s, max_abs_err(zip(got, want)))
        zeros = int((got[0] == 0).sum())
        nonfinite = int((~torch.isfinite(got[1])).sum())
        gh = fef.apply(got[0], ins[4])
        gh_p = fef.apply_plain(got[0], ins[4])
        for name, x, y in zip(("ghat", "err"), gh, gh_p):
            check(bits_equal(x, y), f"apply {name} differs at J={j}")
        err_a = max(err_a, max_abs_err(zip(gh, gh_p)))
        del got, want, gh, gh_p
    res = {"j": j, "grid": EF_GRID, "zeros_of_a": zeros,
           "nonfinite_scores": nonfinite, "scores_err": err_s,
           "apply_err": err_a}
    if timed:
        kw = dict(omega=1.0, mu=MU, Q=0.0)
        a, _ = fef.scores(*ins, **kw)
        res["scores_ms"] = cuda_ms(lambda: fef.scores(*ins, **kw))
        res["scores_plain_ms"] = cuda_ms(lambda: fef.scores_plain(*ins, **kw))
        res["scores_bytes"] = 28 * j       # read 5 vectors, write 2
        res["scores_ops"] = 40 * j         # posterior, tanh polynomials
        res["apply_ms"] = cuda_ms(lambda: fef.apply(a, ins[4]))
        res["apply_plain_ms"] = cuda_ms(lambda: fef.apply_plain(a, ins[4]))
        res["apply_bytes"] = 16 * j        # read 2, write 2
        res["apply_ops"] = 2 * j
    return res


def phase_kernels_fused_ef(dev) -> dict:
    import torch
    small = fused_ef_case(dev, RAGGED_J, seed=5, timed=False)
    emit("kernels_fused_ef_ragged", **small)
    big = fused_ef_case(dev, MAIN_J, seed=4, timed=True)
    emit("kernels_fused_ef_main_shape", **big)
    torch.cuda.empty_cache()
    return {"small": small, "big": big}


def hist_inputs(dev, kind: str, j: int, seed: int):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "zeros":
        return torch.zeros(j, device=dev)
    if kind == "edges":       # |x| = b / 2048 * 4 exactly: on bin edges
        b = torch.randint(0, 2049, (j,), generator=gen, device=dev)
        x = b.float() / 2048 * 4.0
        x[7] = 4.0
        sign = torch.rand(j, generator=gen, device=dev) < 0.5
        return torch.where(sign, -x, x)
    x = torch.randn(j, generator=gen, device=dev)
    if kind == "nan":
        x[torch.randint(0, j, (5,), generator=gen, device=dev)] = float("nan")
    if kind == "concentrated":  # gradient-like: most |x| in bins 0-1
        x *= 1e-3
        x[torch.randint(0, j, (64,), generator=gen, device=dev)] = 2.0
    return x


def bin_edges(amax):
    """(2047,) fp32 t_b, b = 1..2047: the least fp32 y >= 0 whose bin
    reaches b, RN(y / amax) * 2048 >= b, for a finite fp32 amax > 0 (a
    bisection over the bit patterns, which order non-negative floats)."""
    import torch
    from repro_torch.kernels.topk_select import kernel as hk
    b = torch.arange(1, hk.BINS, dtype=torch.float32, device=amax.device)
    lo = torch.zeros(b.shape, dtype=torch.int64, device=amax.device)
    hi = torch.full_like(lo, int(amax.view(torch.int32)))
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        ok = (mid.int().view(torch.float32) / amax) * float(hk.BINS) >= b
        hi, lo = torch.where(ok, mid, hi), torch.where(ok, lo, mid + 1)
    return hi.int().view(torch.float32)


def edge_neighbour_input(dev, j: int, raw_amax: float):
    """Every interior bin edge t_b of amax' = max(raw_amax, 1e-30), its
    two fp32 neighbours, their negatives and amax' itself, repeated to
    length j: the values where a bin is easiest to get wrong."""
    import torch
    from repro_torch.kernels.topk_select import kernel as hk
    amax = torch.tensor(raw_amax, device=dev).clamp(min=hk.AMAX_FLOOR)
    t = bin_edges(amax)
    vals = torch.cat([t, torch.nextafter(t, torch.zeros_like(t)),
                      torch.nextafter(t, torch.full_like(t, float("inf"))),
                      amax.reshape(1)])
    vals = torch.cat([vals, -vals])
    return vals.repeat(-(-j // vals.numel()))[:j].contiguous()


def topk_select_case(dev, j: int, kinds, seed: int, timed: bool) -> dict:
    """B7 (histogram) kernel vs plain on the card, counts equal, for
    the amax the op computes (max |x|, NaN if any x is NaN), and on the
    edge-neighbour inputs for their own amax (0.0 stands for the floor);
    timed: B7 and torch.histc on the Gaussian and the concentrated
    inputs."""
    import torch
    from repro_torch.kernels.topk_select import kernel as hk
    res = {"j": j, "cases": list(kinds) + [
        f"edge_neighbours(amax={a})" for a in HIST_EDGE_AMAX],
        "histogram_err": 0.0}
    cases = [(kind, lambda kind=kind, i=i: hist_inputs(dev, kind, j,
                                                       seed + i), None)
             for i, kind in enumerate(kinds)]
    cases += [(f"edges_{a}", lambda a=a: edge_neighbour_input(dev, j, a), a)
              for a in HIST_EDGE_AMAX]
    for kind, make, raw in cases:
        x = make()
        amax = (x.abs().amax() if raw is None
                else torch.tensor(raw, device=dev))
        got, want = hk.histogram(x, amax), hk.histogram_plain(x, amax)
        check(torch.equal(got, want), f"histogram differs at J={j} ({kind})")
        check(int(got.sum()) == j, f"histogram mass at J={j} ({kind})")
        if kind == "nan":
            nan_amax = hk.histogram(x, torch.tensor(float("nan"), device=dev))
            check(int(nan_amax[0]) == j, "NaN amax: every entry in bin 0")
        if timed and kind in ("gauss", "concentrated"):
            pre = "histogram" if kind == "gauss" else f"histogram_{kind}"
            res[f"{pre}_ms"] = cuda_ms(lambda: hk.histogram(x, amax))
            hi = float(amax)
            res[f"{pre}_histc_ms"] = cuda_ms(lambda: torch.histc(
                x.abs(), bins=hk.BINS, min=0.0, max=hi))
            histc = torch.histc(x.abs(), bins=hk.BINS, min=0.0, max=hi)
            res[f"{pre}_histc_differing_bins"] = int(
                (histc.long() != got.long()).sum())
        if timed and kind == "gauss":
            res["histogram_plain_ms"] = cuda_ms(
                lambda: hk.histogram_plain(x, amax))
            res["histogram_bytes"] = 4 * j + 4 * hk.BINS
            res["histogram_ops"] = 5 * j  # abs, divide, multiply, convert, clip
        del x, got, want
    return res


def phase_kernels_topk_select(dev) -> dict:
    import torch
    small = topk_select_case(dev, RAGGED_J, ("gauss", "zeros", "edges",
                                             "nan", "concentrated"),
                             seed=7, timed=False)
    emit("kernels_topk_select_ragged", **small)
    big = topk_select_case(dev, MAIN_J, ("gauss", "edges", "concentrated"),
                           seed=8, timed=True)
    emit("kernels_topk_select_main_shape", **big)
    torch.cuda.empty_cache()
    return {"small": small, "big": big}


REF_SYNC_CASES = (
    ("dense_exact_sparse", dict(comm_mode="sparse"),
     {"scores": SYNC_STEPS, "apply": SYNC_STEPS}, 0),
    ("dense_histogram_kernel_degrade",
     dict(comm_mode="sparse", selector="histogram_kernel"),
     {"scores": SYNC_STEPS, "apply": SYNC_STEPS, "histogram": SYNC_STEPS}, 1),
    ("sparse_state_simulate",
     dict(comm_mode="simulate", state_format="sparse"), {}, 0),
)


def phase_reference_sync(dev) -> dict:
    """GradientSync on the reference pipeline on the card and on CPU
    copies: g_agg and every state vector bitwise, step by step; the
    launches of each case and its sparse -> simulate warnings."""
    import warnings
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    cpu = torch.device("cpu")
    out = {}
    for name, fields, expect, n_warn in REF_SYNC_CASES:
        cfg = SparsifierConfig(kind="regtopk", sparsity=SPARSITY, mu=MU,
                               pipeline="reference", **fields)
        sync_d, sync_c = GradientSync(cfg), GradientSync(cfg)
        st_d = sparsify.init_state(cfg, REF_SYNC_J, dev)
        st_c = sparsify.init_state(cfg, REF_SYNC_J, cpu)
        gen = torch.Generator(device=cpu).manual_seed(13)
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for t in range(SYNC_STEPS):
                g = torch.randn(REF_SYNC_J, generator=gen)
                g_d, st_d = sync_d(st_d, g.to(dev), donate=True)
                g_c, st_c = sync_c(st_c, g)
                check(bits_equal(g_d.cpu(), g_c),
                      f"reference sync {name} step {t}: g_agg differs")
                check(set(st_d) == set(st_c), f"{name}: state keys")
                for key in st_c:
                    check(bits_equal(st_d[key].cpu(), st_c[key]),
                          f"reference sync {name} step {t}: {key} differs "
                          "card vs CPU")
        launches = launch_counts()
        for kname, n in launches.items():
            check(n == expect.get(kname, 0),
                  f"reference sync {name}: {kname} launched {n} times")
        warned = [str(w.message) for w in caught
                  if issubclass(w.category, RuntimeWarning)]
        check(len(warned) == n_warn, f"{name}: warnings {warned}")
        emit("reference_sync", case=name, j=REF_SYNC_J, steps=SYNC_STEPS,
             comm=sync_d.comm, launches=launches, warnings=warned,
             state=sorted(st_c), bitwise=True)
        out[name] = launches
    return out


def phase_compress(dev) -> None:
    """The fused compressor, REGTOP-k then DGC, on the card and on CPU
    copies: values, indices, every state vector (err_prev, and DGC's
    mom) and the fallback reasons equal, step by step; then both kinds
    again under participation ELASTIC_MASK with err_decay 0.9 (sweep 1's
    gated variant), the payload's count too."""
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    cpu = torch.device("cpu")
    for mask in (None, ELASTIC_MASK):
        for kind in ("regtopk", "dgc"):
            cfg = SparsifierConfig(kind=kind, sparsity=SPARSITY, mu=MU,
                                   comm_mode="sparse", pipeline="fused",
                                   err_decay=ERR_DECAY)
            st_dev = sparsify.init_state(cfg, COMPRESS_J, dev)
            st_cpu = sparsify.init_state(cfg, COMPRESS_J, cpu)
            gen = torch.Generator(device=cpu).manual_seed(7)
            fallbacks = []
            reset_launches()
            for t in range(SYNC_STEPS):
                g = torch.randn(COMPRESS_J, generator=gen)
                p = None if mask is None else torch.tensor(mask[t])
                o_dev = sparsify.compress(
                    cfg, st_dev, g.to(dev),
                    participate=None if p is None else p.to(dev))
                o_cpu = sparsify.compress(cfg, st_cpu, g, participate=p)
                check(set(o_dev.state) == set(o_cpu.state), f"{kind}: keys")
                counts = () if p is None else (
                    ("count", o_dev.count, o_cpu.count),)
                for name, got, want in (
                        ("values", o_dev.values, o_cpu.values),
                        ("indices", o_dev.indices, o_cpu.indices), *counts,
                        *((key, o_dev.state[key], o_cpu.state[key])
                          for key in o_cpu.state)):
                    check(bits_equal(got.cpu(), want),
                          f"compress {kind} mask {mask} step {t}: {name} "
                          "differs card vs CPU")
                check(o_dev.fallback == o_cpu.fallback,
                      f"compress {kind} step {t}: fallback branch differs")
                fallbacks.append(o_dev.fallback)
                st_dev = sparsify.observe_aggregate(
                    cfg, o_dev.state, sparsify.dense_ghat(o_dev, COMPRESS_J),
                    participate=None if p is None else p.to(dev))
                st_cpu = sparsify.observe_aggregate(
                    cfg, o_cpu.state, sparsify.dense_ghat(o_cpu, COMPRESS_J),
                    participate=p)
            launches = launch_counts()
            sweep = ("sweep1_gated" if mask else
                     "sweep1_dgc" if kind == "dgc" else "sweep1")
            for name, n in launches.items():
                check(n == (SYNC_STEPS if name in (sweep, "sweep2") else 0),
                      f"compress {kind} mask {mask}: {name} launched {n}")
            emit("compress", kind=kind, j=COMPRESS_J, steps=SYNC_STEPS,
                 participation=mask, err_decay=ERR_DECAY if mask else None,
                 bitwise=True, fallbacks=fallbacks, state=sorted(st_cpu),
                 launches=launches)


def phase_train(dev, sparsifier: dict, expect: dict, phase: str,
                schedule: str = ""):
    """The launcher's train() on StableLM-3B at full width, 8 layers, with
    the given sparsifier fields and fault schedule; the loss must be
    finite and falling and every kernel's launch count must equal
    ``expect`` (the others 0); under the schedule the steps' n_active
    must be ELASTIC_ACTIVE. Returns (launches by kernel, the run, the
    trained state)."""
    import torch
    from repro_torch.configs.base import (OptimizerConfig, RunConfig, SHAPES,
                                          SparsifierConfig, get_config)
    from repro_torch.launch.train import train
    model = dataclasses.replace(get_config("stablelm-3b"),
                                n_layers=TRAIN_LAYERS)
    check(model.param_count() == MAIN_J, f"J={model.param_count()}")
    run = RunConfig(
        model=model, shape=SHAPES["train_4k"],
        sparsifier=SparsifierConfig(**dict(dict(
            sparsity=SPARSITY, mu=MU, sketch_rows=SKETCH_ROWS), **sparsifier)),
        optimizer=OptimizerConfig(kind="adam", lr=1e-3),
        seed=0, steps=TRAIN_STEPS, log_every=1, fault_schedule=schedule)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.reset_accumulated_memory_stats(dev)

    def on_step(rec):
        emit(f"{phase}_step", **rec,
             **{f"{name}_launches": n for name, n in launch_counts().items()
                if name in expect})

    reset_launches()
    out = train(run, device=dev, batch=8, seq=128, fixed_batch=True,
                log=lambda msg: print(msg, file=sys.stderr),
                on_step=on_step)
    launches = launch_counts()
    losses = [rec["loss"] for rec in out["history"]]
    check(out["params"] == MAIN_J, f"trained J={out['params']}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"{phase}: loss did not fall: {losses}")
    for name, n in launches.items():
        want = expect.get(name, 0)
        check(n == want, f"{phase}: {name} launched {n} times in "
              f"{TRAIN_STEPS} steps, expected {want}")
    active = [rec.get("n_active") for rec in out["history"]]
    if schedule:
        check(active == ELASTIC_ACTIVE, f"{phase}: n_active {active}")
    emit(phase, model=model.name, sparsifier=dataclasses.asdict(
             run.sparsifier), fault_schedule=schedule, n_active=active,
         n_layers=TRAIN_LAYERS,
         j=out["params"], batch=8, seq=128, steps=TRAIN_STEPS,
         losses=losses, step_ms=[rec["ms"] for rec in out["history"]],
         launches=launches, fallbacks=out["fallbacks"],
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         alloc_retries=torch.cuda.memory_stats(dev)["num_alloc_retries"])
    return launches, run, out["state"], [rec["ms"] for rec in out["history"]]


STAGES = ("train/loss_grad", "train/flatten", "train/sync",
          "train/optimizer", "compress/sweeps", "compress/trim",
          "compress/fallback", "sync/combine", "sketch/encode",
          "sketch/allreduce", "sketch/estimate", "sketch/select",
          "compress/scores", "compress/select", "compress/apply",
          "sync/simulate", "sync/dense", "sync/select")


def phase_profile(dev, run, state, phase: str) -> None:
    """Device time of one more step of the trained state, by kernel and
    by the step's record_function stages; busy share = kernel time over
    the step's wall time. Returns the shapes (J, rows, width) of the
    start tables that the step's sync keeps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import lm_batch
    from repro_torch.train.step import build_train_step
    step = build_train_step(run, dev)
    batch = lm_batch(run.model, 8, 128, run.seed, 0, dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device events are kernels and memcpys, plus the GPU-side spans of
    # the record_function stages, which are not work of their own
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in STAGES
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)
    stages = {key: {} for key in STAGES}
    for e in events:
        if e.key in STAGES:
            if e.device_type == DeviceType.CUDA:
                stages[e.key]["device_span_ms"] = e.device_time_total / 1e3
            else:
                stages[e.key]["host_ms"] = e.cpu_time_total / 1e3
    stages = {key: val for key, val in stages.items() if val}
    tables = [list(key[1:]) for key in step.gsync.sketch_tables]
    emit(phase, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms, stages=stages,
         fallback=dict(step.gsync.fallback_reasons),
         sketch_tables=tables,
         top_kernels=[{"name": k[:90], "ms": ms, "calls": n}
                      for k, ms, n in kernels[:15]])
    return tables, wall_ms, stages


def paper_states(cfg, n: int, j: int, gen, g):
    """N workers' stacked states on the CPU with every float vector drawn
    from ``gen`` (REGTOP-k's s_prev 0/1) at step 1, so that the posterior
    is live; every 7th error is -g, an exact zero of a = err + g."""
    import torch
    from repro_torch.core import sparsify
    st = sparsify.stack_states([sparsify.init_state(cfg, j, "cpu")
                                for _ in range(n)])
    for key, val in st.items():
        if key == "step":
            st[key] = torch.ones_like(val)
        elif key == "s_prev":
            st[key] = (torch.rand(val.shape, generator=gen) < 0.3).float()
        else:
            st[key] = torch.randn(val.shape, generator=gen) * 0.1
    if "err" in st:
        st["err"][:, ::7] = -g[:, ::7]
    return st


def paper_round_case(dev, kind: str, n: int, j: int, sparsity: float,
                     seed: int) -> dict:
    """One round of the paper drivers on the card and on CPU copies of the
    same inputs: make_round_fn for topk and regtopk (g_agg and every state
    vector bitwise); for sketchtopk the encodes (a bitwise, the sketch
    within its atomics bound), then the card's mean sketch closes the
    round on both devices (indices, g_agg and every error bitwise). Each
    kernel of the round launches once a worker."""
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    cfg = SparsifierConfig(kind=kind, sparsity=sparsity, mu=MU,
                           selector="exact")
    gen = torch.Generator().manual_seed(seed)
    grads = torch.randn((n, j), generator=gen)
    st_c = paper_states(cfg, n, j, gen, grads)
    st_d = {key: val.to(dev) for key, val in st_c.items()}
    res = {"kind": kind, "n": n, "j": j,
           "k": sparsify.resolve_k(cfg, j), "bitwise": True}
    reset_launches()
    if kind == "sketchtopk":
        sync_d, sync_c = GradientSync(cfg), GradientSync(cfg)
        enc_d = [sync_d.encode(s_, g_) for s_, g_ in zip(
            sparsify.unstack_states(st_d, n), grads.to(dev))]
        enc_c = [sync_c.encode(s_, g_) for s_, g_ in zip(
            sparsify.unstack_states(st_c, n), grads)]
        gaps = []
        for (a_d, sk_d), (a_c, sk_c) in zip(enc_d, enc_c):
            check(bits_equal(a_d.cpu(), a_c), f"paper {kind} J={j}: a")
            gaps.append(sketch_gap(sk_d, sk_c, a_c))
        sk_agg = sync_d.mean_sketch([sk for _, sk in enc_d])
        g_d, new_d, idx_d = sync_d.close_sketch_round(
            sparsify.unstack_states(st_d, n), [a for a, _ in enc_d], sk_agg)
        g_c, new_c, idx_c = sync_c.close_sketch_round(
            sparsify.unstack_states(st_c, n), [a for a, _ in enc_c],
            sk_agg.cpu())
        check(torch.equal(idx_d.cpu(), idx_c), f"paper {kind} J={j}: "
              "indices differ card vs CPU")
        new_d, new_c = (sparsify.stack_states(x) for x in (new_d, new_c))
        res.update(width=sk_agg.shape[1], sketch_err=max(e for e, _ in gaps),
                   sketch_bound_share=max(x for _, x in gaps))
    else:
        g_d, new_d = sparsify.make_round_fn(cfg, n)(st_d, grads.to(dev))
        g_c, new_c = sparsify.make_round_fn(cfg, n)(st_c, grads)
    res["launches"] = launch_counts()
    check(bits_equal(g_d.cpu(), g_c), f"paper {kind} J={j}: g_agg differs "
          "card vs CPU")
    check(set(new_d) == set(new_c), f"paper {kind}: state keys")
    for key in new_c:
        check(bits_equal(new_d[key].cpu(), new_c[key]),
              f"paper {kind} J={j}: {key} differs card vs CPU")
    for name, count in res["launches"].items():
        want = n if name in PAPER_ROUND_KERNELS[kind] else 0
        check(count == want, f"paper {kind} J={j}: {name} launched "
              f"{count} times, expected {want}")
    res["state"] = sorted(new_c)
    return res


def paper_claims(fig1, fig2, genie, fig3) -> dict:
    """The assertions of tests/test_paper_claims.py on the drivers'
    results (fig1 over its first 60 iterations, as the test runs it)."""
    topk1 = fig1["topk"][:60]
    stall = sum(1 for v in topk1 if abs(v - topk1[0]) < 1e-6)
    gap1 = max(abs(a - b) for a, b in zip(fig1["regtopk"][4:40],
                                          fig1["none"][4:40]))
    check(stall >= 45, f"fig1: TOP-1 stalls {stall} iterations")
    check(gap1 < 0.05, f"fig1: REGTOP-1 strays {gap1} from dense")
    check(abs(fig1["regtopk"][8] - fig1["none"][8]) < 0.01, "fig1: t=8")
    check(fig1["regtopk"][20] < 0.1 < fig1["topk"][20], "fig1: t=20")
    dense, topk, reg = (fig2[(0.6, kind)] for kind in
                        ("none", "topk", "regtopk"))
    check(dense[-1] < 1e-3, f"fig2: dense ends at {dense[-1]}")
    check(topk[-1] > 5 * dense[-1], "fig2: TOP-k does not plateau")
    check(topk[-1] > 0.5 * topk[len(topk) // 2], "fig2: TOP-k not flat")
    check(reg[-1] < 1.5 * topk[-1], "fig2: REGTOP-k above 1.5x TOP-k")
    genie_gap = genie[(0.6, "globaltopk")][-1]
    check(genie_gap < 1e-3, f"genie ends at {genie_gap}")
    acc_t, acc_r = fig3["topk"][-1][1], fig3["regtopk"][-1][1]
    check(acc_r >= acc_t - 0.02, f"fig3: regtopk {acc_r} < topk {acc_t}")
    return {"fig1_topk_stall": stall, "fig1_regtopk_gap": gap1,
            "fig2_final": {"none": dense[-1], "topk": topk[-1],
                           "regtopk": reg[-1]},
            "genie_final": genie_gap,
            "fig3_acc": {"topk": acc_t, "regtopk": acc_r}}


def phase_paper(dev) -> dict:
    """The paper's experiments on the card through the port's drivers:
    first one round of each kind at fig2's and fig3's shapes held against
    the CPU, then fig1, fig2 at S = 0.6 (dense, TOP-k, REGTOP-k), the
    genie at fig2's size, EXPERIMENTS.md's fig2 table (REGTOP-k, the
    sketch, the genie at S = 0.4, 0.5, 0.6) and fig3; the claims of
    tests/test_paper_claims.py on the results, each figure's seconds and
    its kernel launches (counted from 0 before it)."""
    import torch
    from repro_torch import paper_experiments as pe
    for i, (n, j, sparsity) in enumerate(PAPER_SHAPES):
        for kind in PAPER_ROUND_KERNELS:
            emit("paper_round", **paper_round_case(dev, kind, n, j,
                                                   sparsity, seed=30 + i))
    # name: (the driver's call, and the (iterations, workers, S values,
    # kinds) its rounds run: each kernel of PAPER_ROUND_KERNELS[kind]
    # launches once a worker a round, no other kernel at all)
    runs = {
        "fig1": (lambda: pe.fig1_toy_logistic(iters=FIG1_ITERS, device=dev),
                 (FIG1_ITERS, 2, 1, ("none", "topk", "regtopk"))),
        "fig2": (lambda: pe.fig2_linreg(
            S_values=(0.6,), iters=FIG2_ITERS,
            kinds=("none", "topk", "regtopk"), device=dev),
            (FIG2_ITERS, 20, 1, ("none", "topk", "regtopk"))),
        "genie": (lambda: pe.fig2_linreg(
            S_values=(0.6,), iters=FIG2_ITERS, kinds=("globaltopk",),
            device=dev), (FIG2_ITERS, 20, 1, ("globaltopk",))),
        "fig2_table": (lambda: pe.fig2_linreg(
            iters=FIG2_TABLE_ITERS,
            kinds=("regtopk", "sketchtopk", "globaltopk"), device=dev),
            (FIG2_TABLE_ITERS, 20, 3, ("regtopk", "sketchtopk",
                                       "globaltopk"))),
        "fig3": (lambda: pe.fig3_nn(iters=FIG3_ITERS, eval_every=FIG3_ITERS,
                                    device=dev),
                 (FIG3_ITERS, 8, 1, ("topk", "regtopk"))),
    }
    out, seconds, launches = {}, {}, {}
    for name, (run, (iters, workers, n_s, kinds)) in runs.items():
        reset_launches()
        t0 = time.perf_counter()
        out[name] = run()
        torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        launches[name] = {key: val for key, val in launch_counts().items()
                          if val}
        want = {}
        for kind in kinds:
            for key in PAPER_ROUND_KERNELS.get(kind, ()):
                want[key] = want.get(key, 0) + iters * workers * n_s
        check(launches[name] == want, f"paper {name}: launches "
              f"{launches[name]}, expected {want}")
        emit(f"paper_{name}", seconds=seconds[name],
             launches=launches[name])
    claims = paper_claims(out["fig1"], out["fig2"], out["genie"], out["fig3"])
    table = out["fig2_table"]
    for kind in ("regtopk", "sketchtopk", "globaltopk"):
        check(all(math.isfinite(table[(s_, kind)][-1])
                  for s_ in (0.4, 0.5, 0.6)), f"fig2 table {kind}")
    print(f"fig2 table, final ||w - w*|| after {FIG2_TABLE_ITERS} "
          "iterations:\n    S   regtopk  sketchtopk  globaltopk", flush=True)
    for s_ in (0.4, 0.5, 0.6):
        print(f"  {s_:.1f}  " + "  ".join(
            f"{table[(s_, kind)][-1]:.2e}"
            for kind in ("regtopk", "sketchtopk", "globaltopk")), flush=True)
    total = {}
    for counts in launches.values():
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
    emit("paper", seconds=seconds, launches=total, claims=claims,
         fig2_table={f"{s_}/{kind}": table[(s_, kind)][-1]
                     for s_ in (0.4, 0.5, 0.6)
                     for kind in ("regtopk", "sketchtopk", "globaltopk")},
         fig2_table_iters=FIG2_TABLE_ITERS)
    return total


WORLD_J = 1 << 24
WORLD_CASES = {      # dense SGD on dyadic gradients (exact in any order)
    "regtopk_fused_sparse": dict(kind="regtopk", pipeline="fused",
                                 comm_mode="sparse"),
    "none": dict(kind="none"),
}


def world_grads(name: str, world: int, j: int):
    """(SYNC_STEPS, world, j) CPU gradients of a world case, the same in
    every rank's process: Gaussian, or dyadic for the dense all-reduce,
    whose sums are then exact in NCCL's order too."""
    import torch
    gen = torch.Generator().manual_seed(19)
    shape = (SYNC_STEPS, world, j)
    if name == "none":
        return dyadic(gen, SYNC_STEPS * world * j, "cpu").reshape(shape)
    return torch.randn(shape, generator=gen)


def world_rank(rank: int, world: int, port: int, backend: str = "nccl",
               j: int = WORLD_J) -> int:
    """One rank of the multi-card check: GradientSync over the process
    group, SYNC_STEPS steps of each WORLD_CASES config; g_agg must be
    bitwise identical on every rank and, like every rank's final state,
    equal to an in-process round() of the same workers (on rank 0).
    ``backend="gloo"`` at a small ``j`` runs the same check on the CPU
    without cards (tests/test_torch_chip_world.py)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    from repro_torch.core.aggregate import GradientSync
    cuda = backend == "nccl"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)

    def gather(x):
        x = x.reshape(-1)
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return out

    try:
        for name, fields in WORLD_CASES.items():
            cfg = SparsifierConfig(sparsity=SPARSITY, mu=MU, **fields)
            grads = world_grads(name, world, j)
            sync = GradientSync(cfg)
            st = sparsify.init_state(cfg, j, dev)
            ip_sync = GradientSync(cfg)
            ip_states = [sparsify.init_state(cfg, j, dev)
                         for _ in range(world)]
            step_ms = []
            for t in range(SYNC_STEPS):
                g = grads[t, rank].to(dev)
                if cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                g_agg, st = sync(st, g)
                if cuda:
                    torch.cuda.synchronize(dev)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                every = gather(g_agg)
                if rank == 0:
                    for r, other in enumerate(every):
                        check(bits_equal(other, every[0]),
                              f"world {name} step {t}: g_agg of rank {r} "
                              "differs from rank 0's")
                    want, ip_states = ip_sync.round(
                        ip_states, [grads[t, r].to(dev)
                                    for r in range(world)])
                    check(bits_equal(g_agg, want), f"world {name} step {t}:"
                          " g_agg differs from the in-process round")
            for key in sorted(st):
                every = gather(st[key])
                if rank == 0:
                    for r, other in enumerate(every):
                        check(bits_equal(other, ip_states[r][key].reshape(-1)),
                              f"world {name}: rank {r}'s {key} differs from "
                              "the in-process round's")
            if rank == 0:
                emit("world", case=name, backend=backend, world=world, j=j,
                     steps=SYNC_STEPS, sparsifier=dataclasses.asdict(cfg),
                     comm=sync.comm, step_ms=step_ms,
                     bitwise_across_ranks=True, equals_round=True,
                     state=sorted(st))
    finally:
        dist.destroy_process_group()
    return 0


def phase_world(world: int, src: str) -> None:
    """Start ``world`` rank processes of this script (one card each, NCCL
    over a localhost rendezvous), relay their output, and stop them all."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--world", str(world),
         "--rank", str(r), "--port", str(port), "--src", src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        print(log, end="", flush=True)
        check(p.returncode == 0, f"world rank {r} exited {p.returncode}")


def compression_shares(steps: dict, profiles: dict) -> dict:
    """Each train cell against the dense baseline of the same run. The
    compression share is the profiled step's compression stages (every
    stage but ``train/*``: the compressor, the sketch and the sync's own
    work) as device ms over the step's wall time. Beside it, on the host
    clock, the median of steps 1..4 (the first step builds and warms up)
    over the dense cell's, share = (cell - dense) / cell; ``resolved`` is
    false where that difference is within the dense cell's own spread
    over the same steps (max - min), which the host's noise can span."""
    dense = steps["train_dense"][1:]
    base, spread = statistics.median(dense), max(dense) - min(dense)
    out = {}
    for name, ms in steps.items():
        med = statistics.median(ms[1:])
        wall, stages = profiles[name]
        comp = sum(val.get("device_span_ms", 0.0)
                   for key, val in stages.items()
                   if not key.startswith("train/"))
        out[name] = {"compression_device_ms": comp,
                     "compression_device_share": comp / wall,
                     "profiled_wall_ms": wall, "step_ms": med,
                     "over_dense_ms": med - base,
                     "share": (med - base) / med,
                     "resolved": abs(med - base) > spread}
    return {"baseline": "train_dense", "dense_spread_ms": spread,
            "cells": out}


def kernel_row(name: str, res: dict, small: dict, launches: int,
               path: str, parity: str, library_ms=None, **extra) -> dict:
    bms, by = bound_ms(res[f"{name}_bytes"], res[f"{name}_ops"])
    source, replaces = KERNEL_META[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(res[f"{name}_err"], small[f"{name}_err"]),
            "ms": res[f"{name}_ms"], "plain_ms": res[f"{name}_plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "path": path, "parity": parity, **extra}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="append", choices=TRAIN_PATHS,
                    help="run only the device and build phases and this "
                    "train phase (repeatable; no profile, no kernels line)")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the port's source tree (default: this checkout's "
                    "src/), e.g. an unpacked older commit's, to compare "
                    "two versions in one run")
    ap.add_argument("--world", type=int, default=0,
                    help="run only the multi-card check: GradientSync over "
                    "NCCL on this many cards (one process each) against an "
                    "in-process round; needs that many cards")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if args.rank is not None:
        return world_rank(args.rank, args.world, args.port)
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    if args.world:
        check(torch.cuda.device_count() >= args.world,
              f"--world {args.world} needs {args.world} cards, found "
              f"{torch.cuda.device_count()}")
        phase_world(args.world, os.path.abspath(args.src))
        return finish(smi, None)
    if args.train:
        for name in args.train:
            fields, kernels, schedule = TRAIN_PATHS[name]
            phase_train(dev, fields, dict.fromkeys(kernels, TRAIN_STEPS),
                        name, schedule)
            torch.cuda.empty_cache()
        return finish(smi, None)
    kres = phase_kernels(dev)
    sres = phase_kernels_sketch(dev)
    eres = phase_kernels_fused_ef(dev)
    hres = phase_kernels_topk_select(dev)
    phase_compress(dev)
    phase_sketch_sync(dev)
    ref_launches = phase_reference_sync(dev)
    phase_paper(dev)
    train, steps, profiles = {}, {}, {}
    for name, (fields, kernels, schedule) in TRAIN_PATHS.items():
        train[name], run, state, steps[name] = phase_train(
            dev, fields, dict.fromkeys(kernels, TRAIN_STEPS), name, schedule)
        tables, *profiles[name] = phase_profile(
            dev, run, state, name.replace("train", "profile"))
        if fields["kind"] == "sketchtopk":
            check(tables == SKETCH_TABLE,
                  f"{name}: the sync keeps one start table of its shape")
        del state
        torch.cuda.empty_cache()
    emit("compression_share", **compression_shares(steps, profiles))
    bitwise = "torch.equal on every output"
    atomics = ("a torch.equal; sketch torch.equal on dyadic inputs, within "
               "4*n_b*2^-24*sum|contrib| per bucket on Gaussian inputs")
    big, small = kres["big"], kres["small"]
    dgc_big, dgc_small = kres["dgc_big"], kres["dgc_small"]
    reference = "reference-launcher default train (reference pipeline)"
    ebig, hbig = eres["big"], hres["big"]
    histc_same = hbig["histogram_histc_differing_bins"] == 0
    rows = [kernel_row("sweep1", big, small, train["train"]["sweep1"],
                       "regtopk train (fused)", bitwise),
            kernel_row("sweep2", big, small, train["train"]["sweep2"],
                       "regtopk train (fused)", bitwise),
            kernel_row("sweep1_dgc", dgc_big, dgc_small,
                       train["train_dgc"]["sweep1_dgc"],
                       "dgc train (fused)", bitwise, mode="dgc"),
            kernel_row("sweep1_gated", kres["gated_big"],
                       kres["gated_small"],
                       train["train_elastic_dgc"]["sweep1_gated"],
                       "elastic dgc train (fused, bursty schedule)",
                       "gate 1: torch.equal to the ungated kernel; gate 0: "
                       "torch.equal to the plain version; both modes",
                       mode="dgc gated",
                       off_ms=kres["gated_big"]["sweep1_gated_off_ms"]),
            kernel_row("sweep1_sketch", sres["big"], sres["small"],
                       train["train_sketch"]["sweep1_sketch"],
                       "sketchtopk train (fused)", atomics, redesigned=True,
                       deterministic=sres["big"][
                           "sweep1_sketch_deterministic"]),
            kernel_row("sketch_encode", sres["big"], sres["small"],
                       train["train_sketch_reference"]["sketch_encode"],
                       "sketchtopk train (reference pipeline, launcher "
                       "defaults)", atomics, redesigned=True,
                       deterministic=sres["big"][
                           "sketch_encode_deterministic"]),
            kernel_row("scores", ebig, eres["small"],
                       train["train_reference"]["scores"],
                       reference, "equal bit patterns on every output"),
            kernel_row("apply", ebig, eres["small"],
                       train["train_reference"]["apply"],
                       reference, "equal bit patterns on every output"),
            kernel_row("histogram", hbig, hres["small"],
                       ref_launches["dense_histogram_kernel_degrade"][
                           "histogram"],
                       "GradientSync, reference pipeline, "
                       "selector=histogram_kernel", bitwise,
                       library_ms=hbig["histogram_histc_ms"] if histc_same
                       else None,
                       library_note=None if histc_same else
                       "none (torch.histc bins differently: "
                       f"{hbig['histogram_histc_differing_bins']} bins "
                       "differ)", redesigned=True)]
    return finish(smi, rows)


def finish(smi: str, rows) -> int:
    """The last lines: the kernel summary (a full run only), the card's
    name and power limit, and the result line."""
    import torch
    if rows is not None:
        print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
