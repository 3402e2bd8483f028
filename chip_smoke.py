#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

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
             CPU copies, bitwise, over 3 REGTOP-k steps at J = 2^24;
5. train:    the port's main path through its launcher: StableLM-3B at
             full width cut to 8 layers, a few REGTOP-k sparse-sync steps,
             with every kernel's launch count read around that run;
6. profile:  one more step of that run under torch.profiler: device time
             by kernel and by stage of the step, and the device busy share.

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
sys.path.insert(0, os.path.join(ROOT, "src"))

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
TIMING_REPS = 10
KERNEL_META = {
    "sweep1": ("src/repro_torch/kernels/compress/csrc/sweep1.cu",
               "src/repro/kernels/compress/kernel.py:78"),
    "sweep2": ("src/repro_torch/kernels/compress/csrc/sweep2.cu",
               "src/repro/kernels/compress/kernel.py:223"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
                    if "registers" in ln or "spill" in ln]
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


def phase_kernels(dev) -> dict:
    import torch
    small = kernel_case(dev, RAGGED_J, seed=1, timed=False)
    emit("kernels_ragged", **small)
    big = kernel_case(dev, MAIN_J, seed=0, timed=True)
    emit("kernels_main_shape", **big)
    torch.cuda.empty_cache()
    return {"small": small, "big": big}


def phase_compress(dev) -> None:
    import torch
    from repro_torch.configs.base import SparsifierConfig
    from repro_torch.core import sparsify
    cfg = SparsifierConfig(kind="regtopk", sparsity=SPARSITY, mu=MU,
                           comm_mode="sparse", pipeline="fused")
    cpu = torch.device("cpu")
    st_dev = sparsify.init_state(cfg, COMPRESS_J, dev)
    st_cpu = sparsify.init_state(cfg, COMPRESS_J, cpu)
    gen = torch.Generator(device=cpu).manual_seed(7)
    fallbacks = []
    for t in range(3):
        g = torch.randn(COMPRESS_J, generator=gen)
        o_dev = sparsify.compress(cfg, st_dev, g.to(dev))
        o_cpu = sparsify.compress(cfg, st_cpu, g)
        for name, got, want in (("values", o_dev.values, o_cpu.values),
                                ("indices", o_dev.indices, o_cpu.indices),
                                ("err_prev", o_dev.state["err_prev"],
                                 o_cpu.state["err_prev"])):
            check(torch.equal(got.cpu(), want),
                  f"compress step {t}: {name} differs card vs CPU")
        check(o_dev.fallback == o_cpu.fallback,
              f"compress step {t}: fallback branch differs")
        fallbacks.append(o_dev.fallback)
        st_dev = sparsify.observe_aggregate(
            cfg, o_dev.state, sparsify.dense_ghat(o_dev, COMPRESS_J))
        st_cpu = sparsify.observe_aggregate(
            cfg, o_cpu.state, sparsify.dense_ghat(o_cpu, COMPRESS_J))
    emit("compress", j=COMPRESS_J, steps=3, bitwise=True,
         fallbacks=fallbacks)


def phase_train(dev):
    """Returns (launches by kernel, the run, the trained state)."""
    import torch
    from repro_torch.configs.base import (OptimizerConfig, RunConfig, SHAPES,
                                          SparsifierConfig, get_config)
    from repro_torch.kernels.compress import kernel as pk
    from repro_torch.launch.train import train
    model = dataclasses.replace(get_config("stablelm-3b"),
                                n_layers=TRAIN_LAYERS)
    check(model.param_count() == MAIN_J, f"J={model.param_count()}")
    run = RunConfig(
        model=model, shape=SHAPES["train_4k"],
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY,
                                    mu=MU, comm_mode="sparse",
                                    pipeline="fused"),
        optimizer=OptimizerConfig(kind="adam", lr=1e-3),
        seed=0, steps=TRAIN_STEPS, log_every=1)
    torch.cuda.reset_peak_memory_stats(dev)

    def on_step(rec):
        emit("train_step", **rec, sweep1_launches=pk.sweep1.launches,
             sweep2_launches=pk.sweep2.launches)

    pk.reset_launches()
    out = train(run, device=dev, batch=8, seq=128, fixed_batch=True,
                log=lambda msg: print(msg, file=sys.stderr),
                on_step=on_step)
    launches = {fn.__name__: fn.launches for fn in pk.KERNELS}
    losses = [rec["loss"] for rec in out["history"]]
    check(out["params"] == MAIN_J, f"trained J={out['params']}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for name, n in launches.items():
        check(n == TRAIN_STEPS, f"{name} launched {n} times in "
              f"{TRAIN_STEPS} steps")
    emit("train", model=model.name, n_layers=TRAIN_LAYERS, j=out["params"],
         batch=8, seq=128, steps=TRAIN_STEPS, losses=losses,
         step_ms=[rec["ms"] for rec in out["history"]],
         launches=launches, fallbacks=out["fallbacks"],
         max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    return launches, run, out["state"]


STAGES = ("train/loss_grad", "train/flatten", "train/sync",
          "train/optimizer", "compress/sweeps", "compress/trim",
          "compress/fallback", "sync/combine")


def phase_profile(dev, run, state) -> None:
    """Device time of one more step of the trained state, by kernel and
    by the step's record_function stages; busy share = kernel time over
    the step's wall time."""
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
    emit("profile", wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms, stages=stages,
         fallback=dict(step.gsync.fallback_reasons),
         top_kernels=[{"name": k[:90], "ms": ms, "calls": n}
                      for k, ms, n in kernels[:15]])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels.compress import kernel as pk
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    kres = phase_kernels(dev)
    phase_compress(dev)
    launches, run, state = phase_train(dev)
    phase_profile(dev, run, state)
    del state
    big = kres["big"]
    rows = []
    for fn in pk.KERNELS:
        name = fn.__name__
        bms, by = bound_ms(big[f"{name}_bytes"], big[f"{name}_ops"])
        source, replaces = KERNEL_META[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(big[f"{name}_err"],
                                        kres["small"][f"{name}_err"]),
                     "ms": big[f"{name}_ms"],
                     "plain_ms": big[f"{name}_plain_ms"],
                     "bound_ms": bms, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
