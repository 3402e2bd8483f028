"""Training launcher of the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --steps 20 --sparsifier regtopk --sparsity 0.01 \
      --fixed-batch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --steps 20 --comm sparse --pipeline fused --fixed-batch \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --sparsifier sketchtopk --device cpu --fixed-batch

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
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fixed-batch", action="store_true",
                    help="reuse step 0's batch every step (overfit mode)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the CUDA card (raises without one)")
    return ap.parse_args(argv)


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
            sketch_width=args.sketch_width),
        optimizer=OptimizerConfig(kind=args.optimizer, lr=args.lr),
        seed=args.seed, steps=args.steps, log_every=args.log_every)


def train(run, *, device=None, group=None, batch: int = 8, seq: int = 128,
          fixed_batch: bool = False, log=print, on_step=None) -> dict:
    """Take ``run.steps`` training steps. Returns {"history": [{"step",
    "loss", "ms"}, ...], "fallbacks": {reason: steps}, "params": J,
    "state": the final TrainState}. Step time is the host
    clock around a step that ends in a device synchronisation."""
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
        history.append(rec)
        if on_step is not None:
            on_step(rec)
        if t % run.log_every == 0 or t == run.steps - 1:
            log(f"step {t:5d} loss {rec['loss']:.4f} "
                f"gnorm {float(metrics['gnorm_local']):.3f} "
                f"nz {float(metrics['agg_nonzero']):.4f} ({ms:.1f} ms)")
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
