#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --train train_sketch_reference [--src OLD/src]

The second form runs only the device and build phases and the named
train phases (no profile, no kernels line), from this checkout's port or
from another source tree: an unpacked older commit's ``src/``, so that
two versions can be compared in one run on one card.

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
             dense score and apply kernels once per step.

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

The last three lines are the per-kernel summary, the card's name and
power limit as ``nvidia-smi`` prints them, and the result line.
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
}
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
    return launches, run, out["state"]


STAGES = ("train/loss_grad", "train/flatten", "train/sync",
          "train/optimizer", "compress/sweeps", "compress/trim",
          "compress/fallback", "sync/combine", "sketch/encode",
          "sketch/allreduce", "sketch/estimate", "sketch/select",
          "compress/scores", "compress/select", "compress/apply",
          "sync/simulate")


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
    return tables


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
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
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
    train = {}
    for name, (fields, kernels, schedule) in TRAIN_PATHS.items():
        train[name], run, state = phase_train(
            dev, fields, dict.fromkeys(kernels, TRAIN_STEPS), name, schedule)
        tables = phase_profile(dev, run, state, name.replace("train",
                                                             "profile"))
        if fields["kind"] == "sketchtopk":
            check(tables == SKETCH_TABLE,
                  f"{name}: the sync keeps one start table of its shape")
        del state
        torch.cuda.empty_cache()
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
