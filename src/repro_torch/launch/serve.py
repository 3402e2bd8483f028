"""Serving launcher of the PyTorch port: prefill a batch of prompts, then
stream greedy decode steps.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --smoke --prompt-len 48 --new-tokens 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \
      --smoke --apply-deltas /tmp/spool \
      --delta-fault-schedule loss:0.4,seed=2 --device cpu

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch granite-8b --smoke --data 4
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch qwen1.5-32b --model 4

The reference launcher's flags (``repro.launch.serve``) and defaults for
what the port serves, plus ``--device`` (default: the CUDA card; ``cpu``
runs the plain PyTorch path). ``--data n`` serves a data-parallel batch
over n ranks started by ``torchrun`` (``launch.mesh.make_group``: NCCL
on a card each, gloo with ``--device cpu``): each rank prefills and
decodes its rows of the global ``--batch``, the logits gathered, and
rank 0 logs. ``--model m`` splits the model over m ranks beside each
data rank (heads, MLA's too, hidden units, experts, Mamba's and the
sLSTM's channels, the mLSTM's value dims, the vocabulary; the cache by
key/value heads and recurrent channels; ``launch.mesh.make_group``),
for every family (an encoder-decoder's cross-attention and ``cross``
cache by heads too; the stubs' patches or frames, drawn from the seed,
the same on every rank); the logits are the vocabulary padded to a
multiple of m. ``--mla-absorb`` serves an MLA model
(deepseek-v2-lite-16b) in the absorbed form. A ``--batch`` below
``--data`` decodes context-parallel: each data rank holds its slice of
the attention cache's slots and the whole of every recurrent state, for
every family (``serve.step``; the prefill runs on one rank's builders
only when the batch splits, so the launcher needs ``--batch`` >=
``--data``). ``--devices`` (the reference's mesh of host devices in one
process) is a ValueError: the port runs one process a rank under
torchrun. The sliding-window variant is a config field (``attn_kind``),
as in the reference. It prints what the reference prints: the prefill's seconds,
the decode's ms a step and the first two sequences. With ``--apply-deltas DIR`` (a
trainer's ``--publish-deltas`` spool) the replica starts from the latest
snapshot under ``DIR/snapshots``, decodes on the tree pinned at that
version, applies the spool's deltas between decode steps (through the
receive-side faults of ``--delta-fault-schedule``), resyncs from a newer
snapshot after a version gap, and prints its health counters; over
more than one rank every rank runs the applier on its own tree (its
shard under ``--model``), and only rank 0 reads the spool and applies
the faults, then broadcasts the payloads to every rank
(``serve.delta.GroupChannel``). The body
is :func:`serve`, which takes a ``RunConfig``, so a caller can pass a
config the flags do not spell (``chip_smoke.py`` passes the sliding
variant).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--apply-deltas", default="",
                    help="subscribe to a trainer's delta broadcast: the "
                         "serving params start from the latest snapshot "
                         "under <dir>/snapshots and the spool's versioned "
                         "deltas apply between decode steps; the decode "
                         "stream stays pinned to the version it started "
                         "on, a version gap triggers a snapshot resync, and "
                         "corrupt or non-finite payloads are dropped on "
                         "health counters. The directory of launch/train.py "
                         "--publish-deltas")
    ap.add_argument("--delta-fault-schedule", default="",
                    help="receive-side delta-channel faults (loss:P | "
                         "corrupt:P | reorder:W | stall:N), the seeded "
                         "schedules the trainer can inject on the send "
                         "side; needs --apply-deltas")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    if args.delta_fault_schedule and not args.apply_deltas:
        ap.error("--delta-fault-schedule needs --apply-deltas")
    return args


def check_args(args) -> None:
    """Raise ValueError for ``--devices``: the reference's mesh of host
    devices in one process, which the port replaces by one process a
    rank. Every model serves on every layout the other flags ask for."""
    if args.devices:
        raise ValueError(
            "--devices: the port runs one process a rank under torchrun "
            "(--nproc-per-node with --data and --model), not a mesh of "
            "devices in one process")


def serve_shape(batch: int, prompt_len: int, new_tokens: int):
    """The decode shape of a serve run: ``batch`` sequences, a cache of
    prompt_len + new_tokens positions."""
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("serve", prompt_len + new_tokens, batch, "decode")


def run_config(args):
    from repro_torch.configs.base import (RunConfig, SparsifierConfig,
                                          get_config, reduced_config)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    if args.mla_absorb:
        cfg = dataclasses.replace(cfg, mla_absorb=True)
    return RunConfig(
        model=cfg, shape=serve_shape(args.batch, args.prompt_len,
                                     args.new_tokens),
        sparsifier=SparsifierConfig(kind="none"), seed=args.seed)


def serve(run, *, device=None, prompt_len: int = 48, new_tokens: int = 16,
          group=None, model_group=None, params: dict = None,
          log=print, applier=None, channel=None, snap_dir: str = "") -> dict:
    """Prefill ``run.shape.global_batch`` random prompts of ``prompt_len``
    tokens (drawn from ``run.seed``, and after them a vision model's
    patches or an audio model's frames, standard normal), then
    ``new_tokens`` greedy decode steps. Returns {"prompt": (B,
    prompt_len), "batch": the prompts' batch, "tokens": (B, new_tokens),
    "prefill_s", "decode_s", "params": the parameter count,
    "prefill_logits", "logits": the last step's, "cache"}.
    Times are the host clock around work that ends in a device
    synchronisation. ``params`` default: drawn from ``run.seed``
    (``transformer.init_rank_params``: under tensor parallelism this
    rank's share).

    Over ``group`` (a data-parallel batch: ``serve.step``) every rank
    draws the same prompts and parameters, serves its rows and holds the
    gathered logits and tokens; the cache is its rows'. Over a
    ``model_group`` each rank holds its share of the parameters and its
    key/value heads of the cache, and the logits are the padded
    vocabulary's. Only rank 0 logs.

    With a ``DeltaApplier`` the stream decodes on the tree that
    ``applier.acquire()`` pins; after each decode step it offers what
    ``channel`` has ready and, on a gap, resyncs from a newer snapshot in
    ``snap_dir``; at the end it flushes the channel (a FaultyChannel's
    held payloads) and resyncs once more if it can. The result then also
    has "delta": the applier's metrics, "pinned_version" and
    "apply_s", the host seconds of those intakes (inside "decode_s")."""
    from repro_torch.backend import resolve_device
    from repro_torch.configs.base import resolve_model_cfg
    from repro_torch.core.flatten import tree_size
    from repro_torch.data.synthetic import stub_inputs
    from repro_torch.models import init_params
    from repro_torch.models.parallel import world
    from repro_torch.models.transformer import init_rank_params
    from repro_torch.serve.step import (build_decode_step, build_prefill,
                                        serve_parallel)
    dev = resolve_device(device)
    tp, model_rank = world(model_group) if model_group is not None \
        else (1, 0)
    pre = build_prefill(run, dev, group=group, model_group=model_group)
    dec = build_decode_step(run, dev, group=group, model_group=model_group)
    ranks, rank = world(group)
    if rank or model_rank:
        log = _quiet
    cfg = resolve_model_cfg(run)
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    pinned_v = None
    if applier is not None:
        params, pinned_v = applier.acquire()
    elif params is None and tp > 1:
        params = init_rank_params(cfg, run.seed, dev, serve_parallel(
            run, group, decode=False, model_group=model_group))
    elif params is None:
        params = init_params(cfg, gen, dev)
    n = tree_size(params)
    b = run.shape.global_batch
    log(f"[serve] {cfg.name}: {n / 1e6:.1f}M params, batch {b}, "
        f"mesh {{'data': {ranks}, 'model': {tp}}}, device={dev}"
        f"{', absorbed MLA' if cfg.mla_absorb else ''}")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, prompt_len),
                                     generator=gen, device=dev)}
    batch.update(stub_inputs(cfg, b, gen, dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    sync()
    t0 = time.perf_counter()
    logits, cache = pre(params, batch)
    sync()
    t_pre = time.perf_counter() - t0
    prefill_logits = logits
    toks = []
    t_apply = 0.0

    def intake(payloads):
        """Offer the payloads, then resync after a gap if a newer snapshot
        is there; returns the host seconds it took."""
        t = time.perf_counter()
        for p in payloads:
            applier.offer(p)
        if applier.needs_resync and applier.can_resync(snap_dir):
            applier.resync_from(snap_dir)
        sync()
        return time.perf_counter() - t
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        nxt = logits.argmax(-1)[:, None]
        toks.append(nxt)
        logits, cache = dec(params, cache, nxt)
        if applier is not None:
            t_apply += intake(channel.recv())
    sync()
    t_dec = time.perf_counter() - t0
    out = torch.cat(toks, 1)
    log(f"prefill {prompt_len} tokens x {b}: {t_pre:.2f}s")
    log(f"decode {new_tokens} steps: {t_dec:.2f}s "
        f"({t_dec / max(new_tokens, 1) * 1e3:.0f} ms/step incl. dispatch)")
    log(f"first sequences: {out[:2].tolist()}")
    res = {"prompt": batch["tokens"], "batch": batch, "tokens": out,
           "prefill_s": t_pre,
           "decode_s": t_dec, "params": n, "prefill_logits": prefill_logits,
           "logits": logits, "cache": cache}
    if applier is not None:
        t_apply += intake(channel.flush() if hasattr(channel, "flush")
                          else [])
        m = applier.metrics()
        log(f"[serve] stream pinned at v{pinned_v}; live params now "
            f"v{m['param_version']}"
            f"{' (resync pending)' if m['needs_resync'] else ''}")
        log(f"[serve] delta health: "
            f"{ {key: m[key] for key in applier.COUNTERS} }")
        res.update(delta=m, pinned_version=pinned_v, apply_s=t_apply)
    return res


def _quiet(msg: str) -> None:
    """The log of a rank other than 0."""


def main(argv=None):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_group
    args = parse_args(argv)
    run = run_config(args)
    check_args(args)
    joined = dist.is_initialized()
    group, model_group, dev = make_group(args.data, args.model,
                                         device=args.device)
    try:
        _serve_main(args, run, group, model_group, dev)
    finally:
        if group is not None and not joined:
            dist.destroy_process_group()
    return 0


def _serve_main(args, run, group, model_group, dev) -> None:
    applier = chan = None
    snap_dir = ""
    if args.apply_deltas:
        import os

        import torch.distributed as dist

        from repro_torch.core import faults
        from repro_torch.serve.delta import (FaultyChannel, GroupChannel,
                                             SpoolChannel)
        from repro_torch.serve.step import delta_applier_from_snapshot
        csched = faults.parse_channel_schedule(args.delta_fault_schedule)
        snap_dir = os.path.join(args.apply_deltas, "snapshots")
        applier, _ = delta_applier_from_snapshot(
            run, snap_dir, dev, group=group, model_group=model_group)
        reader = group is None or dist.get_rank() == 0
        log = print if reader else _quiet
        if reader:
            chan = SpoolChannel(args.apply_deltas)
            if csched is not None:
                chan = FaultyChannel(chan, csched)
                log(f"[serve] delta channel faults (recv side): "
                    f"{faults.format_channel_schedule(csched)}")
        if group is not None:
            chan = GroupChannel(chan, group, model_group, dev)
        log(f"[serve] applying deltas from {args.apply_deltas} "
            f"(snapshot v{applier.version})")
    serve(run, device=dev, prompt_len=args.prompt_len,
          new_tokens=args.new_tokens, group=group, model_group=model_group,
          applier=applier, channel=chan, snap_dir=snap_dir)


if __name__ == "__main__":
    sys.exit(main())
