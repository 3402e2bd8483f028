"""Training launcher of the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --steps 20 --sparsifier regtopk --sparsity 0.01 \
      --fixed-batch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --steps 20 --comm sparse --pipeline fused --fixed-batch \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --sparsifier sketchtopk --device cpu --fixed-batch
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --drop-prob 0.3 --err-decay 0.9 --fixed-batch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --sparsifier none --fixed-batch --device cpu

Flag names and defaults are the reference launcher's
(``repro.launch.train``: simulate comm, the reference pipeline, the exact
selector) for what the port serves, plus ``--device`` (default: the CUDA
card; ``cpu`` runs the plain PyTorch path). Configs the port does not
serve yet raise NotImplementedError naming their ROADMAP item. The body
is :func:`train`, which takes a ``RunConfig``, so a caller can pass a
config the flags do not spell (``chip_smoke.py`` passes StableLM-3B cut
in depth). It runs one process; a caller that has initialised
``torch.distributed`` passes its group.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sparsifier", default="regtopk")
    ap.add_argument("--sparsity", type=float, default=0.01)
    ap.add_argument("--mu", type=float, default=0.5)
    ap.add_argument("--sketch-rows", type=int, default=3,
                    help="CountSketch rows for kind='sketchtopk'")
    ap.add_argument("--sketch-width", type=int, default=0,
                    help="CountSketch width for kind='sketchtopk'; 0 "
                         "-> 4*k clamped to [256, 2^22] (warns once at "
                         "the cap)")
    ap.add_argument("--comm", default="simulate",
                    choices=["simulate", "sparse", "dense"])
    ap.add_argument("--pipeline", default="reference",
                    choices=["reference", "fused"])
    ap.add_argument("--selector", default="exact",
                    choices=["exact", "histogram"],
                    help="top-k selection rule: exact lax.top_k order, or "
                         "threshold selection at a linear-histogram bin "
                         "edge (reference pipeline; packs no pairs, so "
                         "--comm sparse degrades to simulate with a "
                         "warning)")
    ap.add_argument("--err-decay", type=float, default=1.0,
                    help="per-step decay of a sitting-out worker's "
                         "error-feedback memory: err' = err_decay * err on "
                         "steps it sits out (1.0 keeps it)")
    ap.add_argument("--combine", default="mean", choices=["mean", "support"],
                    help="elastic combine: mean = sum over active workers "
                         "/ n_active; support = each coordinate divided by "
                         "the number of active workers that selected it")
    ap.add_argument("--fault-schedule", default="",
                    help="fault injection: 'iid:P[,seed=S]' drops each "
                         "worker each step with probability P; 'bursty:"
                         "period=P,outage=O[,workers=i+j]' sits the listed "
                         "workers out for the first O of every P steps; "
                         "'permanent:step=T[,workers=i]' drops them from "
                         "step T on. Empty: every worker takes part")
    ap.add_argument("--drop-prob", type=float, default=0.0,
                    help="shorthand for --fault-schedule iid:<p>")
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fixed-batch", action="store_true",
                    help="reuse step 0's batch every step (overfit mode)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the CUDA card (raises without one)")
    return ap.parse_args(argv)


def resolve_fault_spec(args) -> str:
    """--drop-prob is shorthand for --fault-schedule iid:<p>; the two
    conflict. The spec is validated here, at launch."""
    spec = args.fault_schedule.strip()
    if args.drop_prob:
        if spec:
            raise SystemExit("--drop-prob is shorthand for --fault-schedule "
                             f"iid:<p>; it conflicts with --fault-schedule "
                             f"{spec!r}: pass one of them")
        spec = f"iid:{args.drop_prob}"
    if spec:
        from repro_torch.core import faults
        faults.parse_schedule(spec)
    return spec


def run_config(args):
    from repro_torch.configs.base import (OptimizerConfig, RunConfig, SHAPES,
                                          SparsifierConfig, get_config,
                                          reduced_config)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    return RunConfig(
        model=cfg, shape=SHAPES["train_4k"],
        sparsifier=SparsifierConfig(
            kind=args.sparsifier, sparsity=args.sparsity, mu=args.mu,
            comm_mode=args.comm, pipeline=args.pipeline,
            selector=args.selector, sketch_rows=args.sketch_rows,
            sketch_width=args.sketch_width, err_decay=args.err_decay,
            combine=args.combine),
        optimizer=OptimizerConfig(kind=args.optimizer, lr=args.lr),
        seed=args.seed, steps=args.steps, log_every=args.log_every,
        fault_schedule=resolve_fault_spec(args))


def train(run, *, device=None, group=None, batch: int = 8, seq: int = 128,
          fixed_batch: bool = False, log=print, on_step=None) -> dict:
    """Take ``run.steps`` training steps. Returns {"history": [{"step",
    "loss", "ms"} (and "n_active" under a fault schedule), ...],
    "fallbacks": {reason: steps}, "params": J, "state": the final
    TrainState}. Step time is the host clock around a step that ends in
    a device synchronisation."""
    from repro_torch.backend import resolve_device
    from repro_torch.core.flatten import tree_size
    from repro_torch.data import lm_batch
    from repro_torch.train.step import build_train_step, init_train_state
    dev = resolve_device(device)
    step = build_train_step(run, dev, group)
    state = init_train_state(run, dev, group)
    j = tree_size(state.params)
    log(f"[train] {run.model.name}: {j:,} params, sparsifier="
        f"{run.sparsifier.kind}@{run.sparsifier.sparsity}, device={dev}")
    if run.fault_schedule:
        from repro_torch.core import faults
        from repro_torch.core.aggregate import world
        sched = faults.parse_schedule(run.fault_schedule)
        n, _ = world(group)
        sp = run.sparsifier
        log(f"[train] fault schedule: {faults.format_schedule(sched)} "
            f"(E[n_active]={faults.expected_active(sched, n):.2f}/{n}, "
            f"err_decay={sp.err_decay}, combine={sp.combine})")
    history = []
    data = None
    for t in range(run.steps):
        if data is None or not fixed_batch:
            data = lm_batch(run.model, batch, seq, run.seed,
                            0 if fixed_batch else t, dev)
        t0 = time.perf_counter()
        state, metrics = step(state, data)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"step": t, "loss": float(metrics["loss"]), "ms": ms}
        if "n_active" in metrics:
            rec["n_active"] = float(metrics["n_active"])
        history.append(rec)
        if on_step is not None:
            on_step(rec)
        if t % run.log_every == 0 or t == run.steps - 1:
            health = (f"active {rec['n_active']:.0f} "
                      if "n_active" in rec else "")
            log(f"step {t:5d} loss {rec['loss']:.4f} "
                f"gnorm {float(metrics['gnorm_local']):.3f} "
                f"nz {float(metrics['agg_nonzero']):.4f} {health}"
                f"({ms:.1f} ms)")
    return {"history": history,
            "fallbacks": dict(step.gsync.fallback_reasons),
            "params": j, "state": state}


def main(argv=None):
    args = parse_args(argv)
    train(run_config(args), device=args.device, batch=args.batch,
          seq=args.seq, fixed_batch=args.fixed_batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
