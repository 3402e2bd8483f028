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
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --comm sparse --pipeline fused --num-buckets 8 \
      --wire-dtype bfloat16 --selector histogram --fixed-batch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --comm sparse --pipeline fused --allocation adaptive \
      --overlap backward --fixed-batch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \
      --smoke --comm sparse --pipeline fused --fixed-batch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --smoke --comm sparse --pipeline fused --fixed-batch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --steps 12 --publish-deltas /tmp/spool --delta-k 4096 \
      --delta-snapshot-every 4 --checkpoint-dir /tmp/ckpt --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch stablelm-3b --smoke --comm sparse --pipeline fused --data 4
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch granite-moe-3b-a800m --smoke --comm sparse --pipeline fused \
      --data 2 --model 2

``--arch`` takes every config of the registry: the dense stablelm-3b,
granite-8b, qwen1.5-32b and starcoder2-7b, the MoE granite-moe-3b-a800m
and deepseek-v2-lite-16b (MLA, shared experts, a dense first layer), the
recurrent xlstm-125m (mLSTM and sLSTM), the hybrid jamba-v0.1-52b
(Mamba, attention, MoE), the vision phi-3-vision-4.2b (a patch stub) and
the encoder-decoder whisper-small (a frame stub); the steps of a model
with MoE layers also log the aux terms ``lb``, ``z`` and ``drop`` (each
summed over the MoE layers).

Flag names and defaults are the reference launcher's
(``repro.launch.train``: simulate comm, the reference pipeline, the exact
selector) for what the port serves, plus ``--device`` (default: the CUDA
card; ``cpu`` runs the plain PyTorch path). ``--num-buckets 0`` logs
the auto-tuned count (``train.step.auto_num_buckets_for_run``). The
reference launcher has no flag for ``SparsifierConfig.ef_dtype``, nor has
this one: a bf16 error state is a config field. The body
is :func:`train`, which takes a ``RunConfig``, so a caller can pass a
config the flags do not spell (``chip_smoke.py`` passes StableLM-3B cut
in depth), and a process group.

``--data``, ``--pods`` and ``--model`` (the reference's mesh flags) ask
for ``data * pods`` data-parallel ranks of ``model`` tensor-parallel
ranks each, one process a rank, started by ``torchrun``: each joins the
default process group on its own card (NCCL), or on the CPU over gloo
with ``--device cpu``, and its data and model groups
(``launch.mesh.make_group``: rank r is data index r // model, model
index r % model). ``--model`` > 1 splits every family (heads, MLA's
and cross-attention's too, hidden units, experts, Mamba's and the
sLSTM's channels, the mLSTM's value dims, vocabulary; the residual
stream by sequence; the encoder takes the whole frames on every rank).
Under it rank 0 writes checkpoints of the parameters joined over the
model group and of the states in the reference's ``(DP, TP, ...)``
layout, and publishes deltas of the joined parameters. ``--batch`` is
the global batch, as in the reference: data rank d trains on its rows
[d B/n, (d + 1) B/n), the same rows (and stub inputs) on every model
rank. Rank 0 logs. Ring attention has no flag, as the reference's
launcher has none: :func:`train` takes ``attn_dist="ring"``.
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
    ap.add_argument("--num-buckets", type=int, default=1,
                    help="bucketed compression: the fused sweeps run per "
                         "contiguous bucket (one merged-histogram "
                         "threshold) and the sparse all-gather in as many "
                         "chunks; selection is bucketing-invariant; 1 "
                         "disables bucketing; 0 auto-tunes the count "
                         "from the sparse all-gather's payload against "
                         "the collective launch floor (logged at start)")
    ap.add_argument("--allocation", default="global",
                    choices=["global", "proportional", "adaptive"],
                    help="density allocation: how the budget k splits over "
                         "layer-aligned segments of the flat gradient "
                         "before selection. global = one flat top-k (the "
                         "paper); proportional = k_l ~ segment size; "
                         "adaptive = k_l from per-segment second moments "
                         "of the score. Every mode keeps sum(k_l) == k, "
                         "so the sparse wire is unchanged. Needs "
                         "--selector exact")
    ap.add_argument("--num-segments", type=int, default=0,
                    help="segment count for --allocation != global (and "
                         "the stream's under --overlap backward): 0 "
                         "follows --num-buckets (or 8 for one bucket); "
                         "the cut is aligned to parameter leaves")
    ap.add_argument("--overlap", default="none",
                    choices=["none", "backward"],
                    help="streaming compression: backward feeds the "
                         "gradient into the fused pipeline one "
                         "layer-aligned segment at a time as the backward "
                         "pass produces it, its sweeps running on a side "
                         "CUDA stream; the trim, pack and collective are "
                         "the only barrier. The same bits as none; needs "
                         "--pipeline fused")
    ap.add_argument("--selector", default="exact",
                    choices=["exact", "histogram"],
                    help="top-k selection rule: exact lax.top_k order, or "
                         "threshold selection: on the fused pipeline at the "
                         "bit-pattern bin edge of the k-th |score| (count in "
                         "[k, 2k], fixed-size packed pairs), on the "
                         "reference pipeline at a linear-histogram bin edge "
                         "(packs no pairs, so --comm sparse degrades to "
                         "simulate with a warning)")
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="dtype of the packed values the sparse all-gather "
                         "moves (indices stay 4-byte): bfloat16 cuts the "
                         "wire from 8 to 6 bytes a pair")
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
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks a pod (one process each, "
                         "under torchrun)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel degree (ranks a model group, one "
                         "process each, under torchrun): every family, "
                         "the encoder-decoder and the vision stub among "
                         "them; checkpoints and deltas of the parameters "
                         "joined over the group")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods; the data-parallel ranks are data * pods, "
                         "pod-major")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fixed-batch", action="store_true",
                    help="reuse step 0's batch every step (overfit mode)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--publish-deltas", default="",
                    help="spool directory of the learning-while-serving "
                         "delta broadcast: after each optimizer step the "
                         "trainer publishes a version-stamped, checksummed "
                         "top-k delta of its params there (and full resync "
                         "snapshots under <dir>/snapshots), which a replica "
                         "started with launch/serve.py --apply-deltas "
                         "consumes")
    ap.add_argument("--delta-k", type=int, default=0,
                    help="entries per published delta; 0 resolves from "
                         "--sparsity over the whole flat model (the "
                         "gradient sync's k)")
    ap.add_argument("--delta-every", type=int, default=1,
                    help="publish every N optimizer steps (>=1)")
    ap.add_argument("--delta-snapshot-every", type=int, default=0,
                    help="write a full resync snapshot every N published "
                         "versions (0: only the version-0 base and the "
                         "final snapshot)")
    ap.add_argument("--delta-fault-schedule", default="",
                    help="send-side delta-channel faults: 'loss:P' drops "
                         "each version with probability P; 'corrupt:P' "
                         "flips a bit in flight (the replica's checksum "
                         "catches it); 'reorder:W' delays each version by a "
                         "seeded amount <= W; 'stall:N[,at=V]' pauses the "
                         "link for N versions and flushes them in order")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--trace-out", default="",
                    help="trace every step (repro_torch.trace, with no "
                         "profiler) and write the record of the last "
                         "steps to this path as Chrome trace-event JSON "
                         "(rank r > 0: PATH.rank<r>)")
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
            selector=args.selector, num_buckets=args.num_buckets,
            wire_dtype=args.wire_dtype, sketch_rows=args.sketch_rows,
            sketch_width=args.sketch_width, err_decay=args.err_decay,
            combine=args.combine, allocation=args.allocation,
            num_segments=args.num_segments, overlap=args.overlap),
        optimizer=OptimizerConfig(kind=args.optimizer, lr=args.lr),
        seed=args.seed, steps=args.steps, log_every=args.log_every,
        fault_schedule=resolve_fault_spec(args),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)


def delta_options(args) -> dict:
    """The delta broadcast's keyword arguments of :func:`train`; the
    channel fault spec is validated here, at launch."""
    spec = args.delta_fault_schedule.strip()
    if spec:
        from repro_torch.core import faults
        faults.parse_channel_schedule(spec)
    return dict(publish_deltas=args.publish_deltas, delta_k=args.delta_k,
                delta_every=args.delta_every,
                delta_snapshot_every=args.delta_snapshot_every,
                delta_fault_schedule=spec)


def _quiet(msg: str) -> None:
    """The log of a rank other than 0."""


def train(run, *, device=None, group=None, model_group=None, batch: int = 8,
          seq: int = 128,
          fixed_batch: bool = False, log=print, on_step=None,
          publish_deltas: str = "", delta_k: int = 0, delta_every: int = 1,
          delta_snapshot_every: int = 0,
          delta_fault_schedule: str = "", attn_dist: str = "sp",
          trace_out: str = "") -> dict:
    """Take ``run.steps`` training steps over the data ``group`` (None:
    one rank) and the ``model_group`` (None: tensor-parallel degree 1),
    each on this data rank's rows of a global ``batch`` x ``seq`` batch
    (the same draw on every rank). Returns {"history": [{"step",
    "loss", "ms"} (and "lb_loss", "z_loss", "drop_frac" for an MoE
    model, "n_active" under a fault schedule, "count" where
    the packed payload has a live count: the fused histogram selector,
    participation; "publish_ms" where a delta was published), ...],
    "fallbacks": {reason: steps}, "params": J, "state": the final
    TrainState, "publisher": the DeltaPublisher or None}. Step time is
    the host clock around a step that ends in a device synchronisation,
    and so is the publish time. Only rank 0 logs. ``attn_dist="ring"``
    trains with ring attention over the model group
    (``train.step.build_train_step``).

    With ``publish_deltas`` (a spool directory) rank 0 publishes a delta
    of its params (under tensor parallelism the tree joined over its
    model group in host memory, ``train.step.joined_params``, where the
    publisher's mirror then lives too) every ``delta_every``
    steps after the optimizer step
    (``delta_k`` entries; 0: the sparsifier's k over the whole model),
    through ``delta_fault_schedule``'s send-side faults, and writes
    resync snapshots under ``<dir>/snapshots``: the version-0 base, one
    every ``delta_snapshot_every`` versions and the final one. With
    ``run.checkpoint_dir`` it checkpoints every ``run.checkpoint_every``
    steps and at the end, stamped with the published version.

    With ``trace_out`` (a path) every step is traced
    (``repro_torch.trace.enable``, no profiler needed) and at the end the
    record of the last ``trace.RING_STEPS`` steps is written there as
    Chrome trace-event JSON, on the clock of a ``torch.profiler`` export
    (``PATH.rank<r>`` on global rank r > 0)."""
    import os

    from repro_torch.backend import resolve_device
    from repro_torch.core.flatten import tree_size
    from repro_torch.data import lm_batch
    from repro_torch.models.parallel import data_index, world
    from repro_torch.models.transformer import AUX_KEYS
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        joined_params, save_train_state)
    dev = resolve_device(device)
    n, rank = world(group)[0], data_index(group)
    tp, model_rank = world(model_group) if model_group is not None \
        else (1, 0)
    if batch % n:
        raise ValueError(f"a global batch of {batch} rows does not split "
                         f"over {n} data-parallel ranks")
    rows = slice(rank * batch // n, (rank + 1) * batch // n)
    if rank or model_rank:
        log = _quiet
    step = build_train_step(run, dev, group, model_group, attn_dist)
    state = init_train_state(run, dev, group, model_group=model_group,
                             attn_dist=attn_dist)
    j = tree_size(state.params)
    log(f"[train] {run.model.name}: {j:,} params, sparsifier="
        f"{run.sparsifier.kind}@{run.sparsifier.sparsity}, device={dev}")
    if run.sparsifier.num_buckets == 0:
        from repro_torch.train.step import auto_num_buckets_for_run
        nb, j_local, dp = auto_num_buckets_for_run(run, group, model_group,
                                                   attn_dist)
        log(f"[train] num_buckets=0 -> auto-tuned {nb} "
            f"(J_local={j_local:,}, dp={dp})")
    if step.stream_bounds is not None or step.seg_bounds is not None:
        sp = run.sparsifier
        log(f"[train] allocation={sp.allocation} overlap={sp.overlap}: "
            f"{len(step.stream_bounds or step.seg_bounds)} layer-aligned "
            f"segments (num_segments={sp.num_segments})")
    if n > 1:
        log(f"[train] {n} data-parallel ranks, {batch // n} rows of the "
            f"global batch of {batch} each")
    if tp > 1:
        log(f"[train] {tp} tensor-parallel ranks a data rank, {j:,} params "
            "on rank 0")
    if run.fault_schedule:
        from repro_torch.core import faults
        sched = faults.parse_schedule(run.fault_schedule)
        sp = run.sparsifier
        log(f"[train] fault schedule: {faults.format_schedule(sched)} "
            f"(E[n_active]={faults.expected_active(sched, n):.2f}/{n}, "
            f"err_decay={sp.err_decay}, combine={sp.combine})")
    publisher = chan = snap_dir = None
    # data rank 0's model group joins the parameters for rank 0 to publish
    joins = bool(publish_deltas) and rank == 0
    if joins:
        joined = joined_params(state.params, model_group)
    if joins and model_rank == 0:
        from repro_torch.core import faults
        from repro_torch.serve.delta import (FaultyChannel, SpoolChannel,
                                             delta_wire_bytes)
        from repro_torch.train.step import delta_publisher_for_run
        publisher = delta_publisher_for_run(run, joined, delta_k)
        del joined
        chan = SpoolChannel(publish_deltas)
        csched = faults.parse_channel_schedule(delta_fault_schedule)
        if csched is not None:
            chan = FaultyChannel(chan, csched)
            log(f"[train] delta channel faults: "
                f"{faults.format_channel_schedule(csched)}")
        snap_dir = os.path.join(publish_deltas, "snapshots")
        publisher.write_snapshot(snap_dir)           # the version-0 base
        log(f"[train] publishing deltas: k={publisher.k} "
            f"({delta_wire_bytes(publisher.k):,} wire bytes/delta, "
            f"J={publisher.j:,}) every {max(1, delta_every)} steps -> "
            f"{publish_deltas}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def version():
        return publisher.version if publisher is not None else None
    history = []
    data = None
    if trace_out:
        from repro_torch import trace
        trace.enable()
    for t in range(run.steps):
        if data is None or not fixed_batch:
            data = {key: val[rows] for key, val in lm_batch(
                run.model, batch, seq, run.seed, 0 if fixed_batch else t,
                dev).items()}
        t0 = time.perf_counter()
        state, metrics = step(state, data)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"step": t, "loss": float(metrics["loss"]), "ms": ms}
        if run.model.moe is not None:
            rec.update({key: float(metrics[key]) for key in AUX_KEYS})
        if joins and (t + 1) % max(1, delta_every) == 0:
            t0 = time.perf_counter()
            joined = joined_params(state.params, model_group)
            if publisher is not None:
                chan.send(publisher.publish(joined))
            del joined
            sync()
            rec["publish_ms"] = (time.perf_counter() - t0) * 1e3
            if publisher is not None and (
                    delta_snapshot_every
                    and publisher.version % delta_snapshot_every == 0):
                publisher.write_snapshot(snap_dir)
        if (run.checkpoint_every and run.checkpoint_dir
                and t and t % run.checkpoint_every == 0):
            save_train_state(run.checkpoint_dir, t, state, group,
                             param_version=version(),
                             model_group=model_group)
        if "n_active" in metrics:
            rec["n_active"] = float(metrics["n_active"])
        if step.gsync.last_count is not None:
            rec["count"] = int(step.gsync.last_count)
        history.append(rec)
        if on_step is not None:
            on_step(rec)
        if t % run.log_every == 0 or t == run.steps - 1:
            health = (f"active {rec['n_active']:.0f} "
                      if "n_active" in rec else "")
            if "count" in rec:
                health += f"count {rec['count']} "
            if "lb_loss" in rec:
                health += (f"lb {rec['lb_loss']:.4f} z {rec['z_loss']:.4f} "
                           f"drop {rec['drop_frac']:.4f} ")
            log(f"step {t:5d} loss {rec['loss']:.4f} "
                f"gnorm {float(metrics['gnorm_local']):.3f} "
                f"nz {float(metrics['agg_nonzero']):.4f} {health}"
                f"({ms:.1f} ms)")
    if publisher is not None:
        if hasattr(chan, "flush"):
            chan.flush()
        publisher.write_snapshot(snap_dir)
        sent = getattr(chan, "counters", {}).get("sent", publisher.version)
        log(f"[train] published {publisher.version} delta versions ({sent} "
            f"reached the spool); final snapshot at v{publisher.version}")
    if run.checkpoint_dir:
        save_train_state(run.checkpoint_dir, run.steps, state, group,
                         param_version=version(),
                         model_group=model_group)
    if trace_out:
        import torch.distributed as dist
        grank = dist.get_rank() if dist.is_initialized() else 0
        path = trace_out if grank == 0 else f"{trace_out}.rank{grank}"
        trace.disable()
        log(f"[train] trace: {trace.write_chrome(path)} events of the last "
            f"{len(trace.step_ids())} steps -> {trace_out}")
    return {"history": history,
            "fallbacks": dict(step.gsync.fallback_reasons),
            "params": j, "state": state, "publisher": publisher}


def main(argv=None):
    import torch.distributed as dist

    from repro_torch.core.aggregate import check_supported
    from repro_torch.launch.mesh import make_group
    from repro_torch.models.transformer import check_model
    args = parse_args(argv)
    run = run_config(args)
    # what the port does not serve raises before any group is joined
    check_supported(run.sparsifier)
    check_model(run.model)
    joined = dist.is_initialized()
    group, model_group, dev = make_group(args.data, args.model, args.pods,
                                         args.device)
    try:
        train(run, device=dev, group=group, model_group=model_group,
              batch=args.batch, seq=args.seq,
              fixed_batch=args.fixed_batch, trace_out=args.trace_out,
              **delta_options(args))
    finally:
        if group is not None and not joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
