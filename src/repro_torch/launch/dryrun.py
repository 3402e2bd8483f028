"""Dry run: one rank's step of every (architecture x input shape) traced
on the ``meta`` device, without allocating any memory or needing a card
(the port of ``repro.launch.dryrun``). It proves that a configuration
builds on a mesh and gives the flops, bytes and collective wire bytes
that the roofline (``roofline.analysis``) reads.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
        --shape train_4k --mesh 2x2 --out dr.json \\
        [--sparsifier regtopk --sparsity 0.001 --comm sparse]

The reference lowers and compiles its jitted step on abstract arrays;
the port runs rank 0's step eagerly on meta tensors under a process
group of the mesh's size that moves nothing (PyTorch's fake backend, so
every collective the step issues is seen and none waits on a peer), and
counts what it runs (:class:`Tracer`):

- ``hlo_flops``: matmul and convolution flops (``FlopCounterMode``; the
  reference counts dot and convolution flops too);
- ``hlo_bytes``: the bytes of the inputs and outputs of every operation
  that is not a view;
- ``hlo_collectives`` and ``hlo_collective_wire_bytes``: each c10d
  collective's wire bytes a rank, with the reference parser's ring
  factors (all-gather out (g-1)/g, all-reduce out 2(g-1)/g,
  reduce-scatter out (g-1), all-to-all out (g-1)/g; a broadcast out);
- ``unknown_trip_loops``: 0 (eager tracing unrolls every loop); ``flops``,
  ``bytes_accessed`` and ``collective_bytes`` equal the traced counts;
  ``memory``: -1 for every XLA memory statistic, which has no
  counterpart (the reference's own ``getattr(mem, k, -1)``).

The train step's gradient sync reads the device on the host (the fused
pipeline's fallback decision, the trim's counts) and launches kernels,
neither of which a meta tensor can do. Its stage is counted from
contracts instead (:func:`sync_contract`): each kernel on the path by its
``bytes_moved`` (``kernels.*.kernel``), the O(J) plain passes around
them at one read of each input and one write of each output, the
fallback's dense selection counted as taken, and the wire from
``aggregate.sparse_gather_wire_bytes`` and ``sketch_allreduce_bytes``
(or the dense all-reduce). Everything else in the step (the loss and
gradient, the flatten, the norm, ZeRO-1's update and its parameter
all-gather, the metrics) is traced. The record names the stages of
each kind (``stages``). Ring attention (which exchanges blocks point to
point) is not a mesh the dry run takes, as the reference's does not.

The other keys are the reference's: ``num_buckets`` (resolved from 0 by
the train step's own rule) with ``num_buckets_requested``,
``sparse_gather_wire_bytes``, the sketch's fields, ``fault`` and
``delta``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (SHAPES, OptimizerConfig, RunConfig,
                                      SparsifierConfig, active_param_count,
                                      get_config, list_archs)

META = torch.device("meta")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d op -> (collective, the factor of its output bytes a rank sends
# over a group of g)
_C10D = {
    "allreduce_": ("all-reduce", lambda g: 2 * (g - 1) / g),
    "allreduce_coalesced_": ("all-reduce", lambda g: 2 * (g - 1) / g),
    "_allgather_base_": ("all-gather", lambda g: (g - 1) / g),
    "allgather_": ("all-gather", lambda g: (g - 1) / g),
    "allgather_into_tensor_coalesced_": ("all-gather", lambda g: (g - 1) / g),
    "_reduce_scatter_base_": ("reduce-scatter", lambda g: g - 1),
    "reduce_scatter_": ("reduce-scatter", lambda g: g - 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", lambda g: g - 1),
    "alltoall_base_": ("all-to-all", lambda g: (g - 1) / g),
    "alltoall_": ("all-to-all", lambda g: (g - 1) / g),
    "broadcast_": ("collective-permute", lambda g: 1.0),
}


def _tensors(x):
    """The tensors in an argument (nested lists and tuples)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:       # the reduce op, not a group
                continue
    return 1


class Tracer(TorchDispatchMode):
    """Counts what runs under it: the bytes of every non-view
    operation's inputs and outputs, the operations, and each c10d
    collective's wire bytes a rank (the module docstring's factors)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.wire = dict.fromkeys(COLLECTIVES, 0.0)
        self.calls = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d" and name in _C10D:
            kind, factor = _C10D[name]
            g = _group_size(args)
            # the output: the first argument of the in-place collectives
            self.wire[kind] += _nbytes(args[0]) * factor(g) if g > 1 else 0.0
            self.calls[kind] += 1
        if not func.is_view:
            self.ops += 1
            self.bytes += _nbytes(list(args) + list(kwargs.values())) + \
                _nbytes(out)
        return out


def traced(fn, *args):
    """(fn's result, {"flops", "bytes", "ops", "wire": {collective: bytes},
    "calls": {collective: count}}) of one call on meta tensors."""
    tracer = Tracer()
    with FlopCounterMode(display=False) as flops, tracer:
        out = fn(*args)
    return out, {"flops": float(flops.get_total_flops()),
                 "bytes": float(tracer.bytes), "ops": tracer.ops,
                 "wire": tracer.wire, "calls": tracer.calls}


# ---------------------------------------------------------------------------
# The sync's contract
# ---------------------------------------------------------------------------

def sync_contract(cfg: SparsifierConfig, j: int, n: int,
                  gated: bool = False, parts=None) -> dict:
    """The gradient sync of one rank's step at flat length j over n data
    ranks (``gated``: under a participation bit; ``parts``: the (offset,
    size) partition the fused sweeps run over, the allocation's or the
    stream's segments, by default the buckets), counted from
    contracts: {"stages": [(name, bytes)], "bytes",
    "wire": {collective: bytes a rank}, "kernels": {wrapper: launches}}.
    The fused path's sweeps are B1 and B2 by their ``bytes_moved`` at
    each part's length; the other kernels on the path (B3, or B4 and B6
    for the sketch; B5, B6 and B7 on the reference pipeline) the same; a
    plain O(J) pass is one read of each input and one write of each
    output. The fused trim's dense fallback (a top-k over the score,
    decided on the host) is counted as taken."""
    from repro_torch.core import aggregate, sketch, sparsify
    from repro_torch.core.flatten import bucket_bounds
    from repro_torch.kernels.compress import dispatch
    from repro_torch.kernels.compress import kernel as pk
    from repro_torch.kernels.compress.ops import maxpb_for
    from repro_torch.kernels.fused_ef import kernel as fk
    from repro_torch.kernels.topk_select import kernel as hk
    nb = sparsify.resolve_num_buckets(cfg, j, n)
    cfg = dataclasses.replace(cfg, num_buckets=nb)
    sel = sparsify.selection(cfg)
    fused = dispatch.fused(cfg)
    s = getattr(torch, cfg.ef_dtype).itemsize
    k = sparsify.resolve_k(cfg, j)
    stages, kernels = [], {}
    wire = dict.fromkeys(COLLECTIVES, 0.0)
    ring = (n - 1) / n

    def launch(fn, nbytes, stage):
        kernels[fn.__name__] = kernels.get(fn.__name__, 0) + 1
        stages.append((stage, nbytes))

    if sel in ("none", "global"):
        dt = s if sel == "none" else 4
        stages.append(("sync/dense", 2 * j * dt))
        wire["all-reduce"] += 2 * ring * j * dt
        if sel == "global":
            stages.append(("sync/select", 4 * j + 12 * j))   # top-k, mask
        return _contract(stages, wire, kernels)
    if sel == "sketch":
        rows = cfg.sketch_rows
        width = sketch.resolve_width(k, cfg.sketch_width)
        if fused:
            fn = {(4, False): pk.sweep1_sketch,
                  (2, False): pk.sweep1_sketch_bf16,
                  (4, True): pk.sweep1_sketch_gated,
                  (2, True): pk.sweep1_sketch_gated_bf16}[(s, gated)]
            launch(fn, fn.bytes_moved(j, rows, width), "sketch/encode")
        else:
            stages.append(("sketch/encode", (8 + s) * j))     # a = err + g
            launch(pk.sketch_encode, pk.sketch_encode.bytes_moved(
                j, rows, width), "sketch/encode")
        # the estimate reads the mean sketch at each of the rows for every
        # coordinate and writes the estimate; the top-k reads it
        stages.append(("sketch/estimate", 4 * rows * j + 4 * j + 4 * j))
        if fused:
            stages.append(("sync/combine", 4 * j + s * j))    # err = a - ...
        else:
            launch(fk.apply, fk.apply.bytes_moved(j), "compress/apply")
        wire["all-reduce"] += aggregate.sketch_allreduce_bytes(cfg, j, n)
    elif fused:
        dgc = cfg.kind == "dgc"
        maxpb = maxpb_for(k, j)
        for _, size in parts or bucket_bounds(j, nb):
            if gated:
                fn = pk.sweep1_gated if s == 4 else pk.sweep1_gated_bf16
                launch(fn, fn.bytes_moved(size, dgc=dgc), "compress/sweeps")
            else:
                fn = {(False, 4): pk.sweep1, (True, 4): pk.sweep1_dgc,
                      (False, 2): pk.sweep1_bf16,
                      (True, 2): pk.sweep1_dgc_bf16}[(dgc, s)]
                launch(fn, fn.bytes_moved(size), "compress/sweeps")
            launch(pk.sweep2, pk.sweep2.bytes_moved(size, maxpb),
                   "compress/sweeps")
        stages.append(("compress/fallback", 4 * j))
    else:
        # REGTOP-k's O(k) layout scores and scatters in plain ops
        dense = not (cfg.kind == "regtopk" and cfg.state_format == "sparse")
        if cfg.kind == "regtopk" and dense:
            fn = fk.scores if s == 4 else fk.scores_bf16
            launch(fn, fn.bytes_moved(j), "compress/scores")
        else:
            stages.append(("compress/scores", (8 + s) * j))   # a = err + g
        if cfg.selector == "histogram_kernel":
            launch(hk.histogram, hk.histogram.bytes_moved(j),
                   "compress/select")
        stages.append(("compress/select", 4 * j))
        if dense:
            launch(fk.apply, fk.apply.bytes_moved(j), "compress/apply")
    gw = aggregate.sparse_gather_wire_bytes(cfg, j, n)
    if gw is not None:
        wire["all-gather"] += ring * gw
        stages.append(("sync/combine", gw + 4 * j))   # land the pairs
    else:
        wire["all-reduce"] += 2 * ring * j * 4        # the dense ghat
        stages.append(("sync/simulate", 8 * j))
    return _contract(stages, wire, kernels)


def _contract(stages, wire, kernels) -> dict:
    return {"stages": stages, "bytes": float(sum(b for _, b in stages)),
            "wire": wire, "kernels": kernels}


class ContractSync:
    """Stands for the train step's ``GradientSync`` in a traced step: g
    goes in, a g_agg of its shape and dtype comes out, the state as it
    was (its shapes are the sync's), and the stage is counted by
    :func:`sync_contract`."""

    def __init__(self, gsync, n: int):
        self.cfg = gsync.cfg
        self.parts = gsync.stream_bounds or gsync.seg_bounds
        self.n = n
        self.calls = []

    def __call__(self, state, g, participate=None, donate=False,
                 with_stats=False, key=None):
        self.calls.append(sync_contract(self.cfg, g.numel(), self.n,
                                        participate is not None, self.parts))
        g_agg = torch.empty_like(g)
        if not with_stats:
            return g_agg, state
        zero = torch.zeros((), device=g.device)
        return g_agg, state, {"n_active": zero, "dropped_nonfinite": zero}

    def begin(self, state, *, key=None, participate=None):
        return _ContractStream(self, state, participate)


class _ContractStream:
    def __init__(self, sync, state, participate):
        self.sync, self.state, self.p, self.j = sync, state, participate, 0

    def feed_segment(self, g_seg, offset=None):
        self.j += g_seg.numel()
        return self

    def side_outputs(self):
        return []

    def finish(self, *, with_stats=False):
        g = torch.empty(self.j, device=META)
        return self.sync(self.state, g, self.p, with_stats=with_stats)


# ---------------------------------------------------------------------------
# One rank's program on the meta device
# ---------------------------------------------------------------------------

def fake_world(size: int) -> None:
    """Join a fake process group of ``size`` ranks as rank 0 (nothing
    moves), unless one is joined already."""
    if size == 1 or dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def mesh_groups(data: int, model: int, pods: int = 1):
    """(data group, model group) of rank 0 on a (pods x data, model)
    mesh, as ``launch.mesh.make_group`` cuts the group; (None, None) at
    one rank."""
    if data * model * pods == 1:
        return None, None
    from repro_torch.launch.mesh import axis_groups
    fake_world(data * model * pods)
    return axis_groups(data * pods, model)


def _batch(cfg, rows: int, seq: int, targets: bool = True) -> dict:
    """Meta stand-ins of a batch of ``rows`` x ``seq`` tokens (and the
    model's patches or frames)."""
    out = {"tokens": torch.empty((rows, seq), dtype=torch.long, device=META)}
    if targets:
        out["targets"] = torch.empty((rows, seq), dtype=torch.long,
                                     device=META)
    key = {"vision_stub": "patches", "audio_stub": "frames"}.get(cfg.frontend)
    if key is not None:
        out[key] = torch.empty((rows, cfg.n_frontend_tokens, cfg.d_model),
                               device=META)
    return out


def trace_train(run: RunConfig, group=None, model_group=None) -> dict:
    """Rank 0's train step traced on the meta device: the traced counts
    with the sync's contract added; "sync" holds the contract,
    "traced" the rest."""
    from repro_torch.models import init_params
    from repro_torch.models.parallel import world
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        train_parallel)
    step = build_train_step(run, META, group, model_group)
    params = init_params(run.model, torch.Generator(), META,
                         train_parallel(group, model_group))
    state = init_train_state(run, META, group, params=params,
                             model_group=model_group)
    n = world(group)[0]
    step.gsync = ContractSync(step.gsync, n)
    rows = run.shape.global_batch // n
    _, counts = traced(step, state, _batch(run.model, rows,
                                           run.shape.seq_len))
    (sync,) = step.gsync.calls
    return _merge(counts, sync)


def _merge(counts: dict, sync=None) -> dict:
    wire = dict(counts["wire"])
    out = {"traced": counts, "sync": sync, "flops": counts["flops"],
           "bytes": counts["bytes"]}
    if sync is not None:
        out["bytes"] += sync["bytes"]
        for key, val in sync["wire"].items():
            wire[key] += val
    out["wire"] = wire
    return out


def trace_serve(run: RunConfig, kind: str, group=None,
                model_group=None) -> dict:
    """Rank 0's prefill or decode step traced on the meta device."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.parallel import world
    from repro_torch.serve.step import (build_decode_step, build_prefill,
                                        decode_cache_layout, serve_parallel)
    cfg = run.model
    pal = serve_parallel(run, group, decode=kind == "decode",
                         model_group=model_group)
    params = tfm.init_params(cfg, torch.Generator(), META, pal)
    b, seq = run.shape.global_batch, run.shape.seq_len
    if kind == "prefill":
        fn = build_prefill(run, META, group=group, model_group=model_group)
        _, counts = traced(fn, params, _batch(cfg, b, seq, targets=False))
        return _merge(counts)
    fn = build_decode_step(run, META, group=group, model_group=model_group)
    rows, _ = decode_cache_layout(run, world(group)[0], pal.cache_seq_sharded)
    cache = tfm.init_decode_cache(
        cfg, rows, seq, getattr(torch, cfg.dtype), META, pal,
        enc_seq=cfg.n_frontend_tokens if cfg.is_encoder_decoder else 0)
    token = torch.empty((b, 1), dtype=torch.long, device=META)
    _, counts = traced(fn, params, cache, token)
    return _merge(counts)


def run_config(arch: str, shape, *, sparsifier="regtopk", sparsity=0.001,
               comm="sparse", state_format="dense", ef_dtype="float32",
               pipeline="reference", num_buckets=1, selector="exact",
               wire_dtype="float32", allocation="global", num_segments=0,
               fault_schedule="", err_decay=1.0, combine="mean",
               overlap="none", sketch_rows=3, sketch_width=0,
               **cfg_overrides) -> RunConfig:
    """The reference dry run's RunConfig: ``arch`` with ``cfg_overrides``
    (``moe_*`` keys into its MoEConfig), Adam, and a dense model's
    sliding variant at ``long_500k``. ``shape``: a name of ``SHAPES`` or
    a ``ShapeConfig``."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch)
    moe_over = {k[4:]: v for k, v in cfg_overrides.items()
                if k.startswith("moe_") and k != "moe_every"}
    cfg_overrides = {k: v for k, v in cfg_overrides.items()
                     if not (k.startswith("moe_") and k != "moe_every")}
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if moe_over and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_over))
    attn_override = ""
    if shape.name == "long_500k" and cfg.attn_kind == "full" and \
            cfg.family not in ("ssm",) and cfg.attn_every == 1:
        attn_override = "sliding"   # dense archs: sliding-window variant
    return RunConfig(
        model=cfg, shape=shape,
        sparsifier=SparsifierConfig(
            kind=sparsifier, sparsity=sparsity, comm_mode=comm,
            selector=selector, mu=0.5, state_format=state_format,
            ef_dtype=ef_dtype, pipeline=pipeline, num_buckets=num_buckets,
            allocation=allocation, num_segments=num_segments,
            wire_dtype=wire_dtype, err_decay=err_decay, combine=combine,
            overlap=overlap, sketch_rows=sketch_rows,
            sketch_width=sketch_width),
        optimizer=OptimizerConfig(kind="adam", lr=1e-4),
        attn_override=attn_override, fault_schedule=fault_schedule)


def dryrun_one(arch: str, shape_name: str, mesh: tuple, *, verbose=True,
               variant="", delta_k=0, delta_fault_schedule="",
               **run_kw) -> dict:
    """One record: ``mesh`` is (data, model) or (pods, data, model)."""
    from repro_torch.configs.base import resolve_model_cfg
    from repro_torch.core import aggregate, faults
    from repro_torch.train.step import auto_num_buckets_for_run
    pods, data, model = (1, *mesh) if len(mesh) == 2 else mesh
    run = run_config(arch, shape_name, **run_kw)
    run = dataclasses.replace(run, model=resolve_model_cfg(run))
    sp = run.sparsifier
    kind = run.shape.kind
    group, model_group = mesh_groups(data, model, pods)
    num_buckets = sp.num_buckets
    gather_wire = fault_rec = num_stream_segments = sketch_rec = None
    if kind == "train":
        # the train step's own resolution and its J_local and dp
        nb_auto, j_local, dp = auto_num_buckets_for_run(run, group,
                                                        model_group)
        if sp.num_buckets == 0:
            num_buckets = nb_auto
        gather_wire = aggregate.sparse_gather_wire_bytes(sp, j_local, dp)
        skb = aggregate.sketch_allreduce_bytes(sp, j_local, dp)
        if skb is not None:
            from repro_torch.core import sketch
            from repro_torch.core.sparsify import resolve_k
            sketch_rec = {
                "sketch_rows": sp.sketch_rows,
                "sketch_width_effective": sketch.resolve_width(
                    resolve_k(sp, j_local), sp.sketch_width),
                "sketch_allreduce_bytes": float(skb)}
        if sp.overlap == "backward":
            from repro_torch.train.step import build_train_step
            num_stream_segments = len(build_train_step(
                run, META, group, model_group).stream_bounds)
        if run.fault_schedule:
            sched = faults.parse_schedule(run.fault_schedule)
            fault_rec = faults.describe(sched, dp)
            gw_act = aggregate.sparse_gather_wire_bytes(
                sp, j_local, dp, n_active=fault_rec["n_active_expected"])
            if gw_act is not None:
                fault_rec["sparse_gather_wire_bytes_active"] = float(gw_act)
    t0 = time.time()
    res = trace_train(run, group, model_group) if kind == "train" else \
        trace_serve(run, kind, group, model_group)
    t_trace = time.time() - t0
    n_params = run.model.param_count()
    coll = dict(res["wire"], total=sum(res["wire"].values()))
    rec = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": ({"pod": pods} if pods > 1 else {}) | {"data": data,
                                                       "model": model},
        "kind": kind, "attn_override": run.attn_override,
        "num_buckets": num_buckets, "num_buckets_requested": sp.num_buckets,
        "allocation": sp.allocation,
        "params": int(n_params),
        "active_params": int(active_param_count(run.model)),
        "flops": res["flops"], "bytes_accessed": res["bytes"],
        "collective_bytes": coll,
        "hlo_flops": res["flops"], "hlo_bytes": res["bytes"],
        "hlo_collectives": res["wire"],
        "hlo_collective_wire_bytes": coll["total"],
        "unknown_trip_loops": 0,
        "t_lower_s": round(t_trace, 1), "t_compile_s": 0.0,
        "wire_dtype": sp.wire_dtype, "overlap": sp.overlap,
        "memory": dict.fromkeys(
            ("temp_size_in_bytes", "argument_size_in_bytes",
             "output_size_in_bytes", "generated_code_size_in_bytes",
             "alias_size_in_bytes", "peak_memory_in_bytes"), -1),
        "stages": {"traced": _traced_stages(kind),
                   "contract": [] if res["sync"] is None else ["train/sync"]},
        "traced_ops": res["traced"]["ops"],
        "traced_collective_calls": res["traced"]["calls"],
    }
    if res["sync"] is not None:
        rec["sync_contract"] = {
            "bytes": res["sync"]["bytes"], "wire": res["sync"]["wire"],
            "kernels": res["sync"]["kernels"],
            "stages": [list(s) for s in res["sync"]["stages"]]}
    if gather_wire is not None:
        rec["sparse_gather_wire_bytes"] = int(gather_wire)
    if num_stream_segments is not None:
        rec["num_stream_segments"] = int(num_stream_segments)
    if sketch_rec is not None:
        rec.update(sketch_rec)
    if fault_rec is not None:
        rec["fault"] = fault_rec
    if delta_k:
        from repro_torch.serve.delta import (delta_wire_bytes, resync_bytes,
                                             resync_equiv_deltas)
        k_eff = int(min(delta_k, n_params))
        rec["delta"] = {
            "k": k_eff,
            "wire_bytes": int(delta_wire_bytes(k_eff)),
            "resync_bytes": int(resync_bytes(n_params)),
            "resync_equiv_deltas": float(resync_equiv_deltas(n_params,
                                                             k_eff))}
        if delta_fault_schedule:
            rec["delta"]["fault"] = faults.describe_channel(
                faults.parse_channel_schedule(delta_fault_schedule))
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={rec['mesh']}: "
              f"traced in {t_trace:.1f}s on the meta device", flush=True)
        print("  flops={:.3e} bytes={:.3e} wire={:.3e}".format(
            rec["hlo_flops"], rec["hlo_bytes"],
            rec["hlo_collective_wire_bytes"]))
        print("  collectives(wire):",
              {k: f"{v:.3e}" for k, v in rec["hlo_collectives"].items()
               if v}, flush=True)
    return rec


def _traced_stages(kind: str) -> list:
    if kind == "train":
        return ["train/loss_grad", "train/flatten", "train/optimizer",
                "train/metrics"]
    return [f"serve/{kind}"]


def parse_overrides(pairs) -> dict:
    """``--set key=value`` pairs: true/false, int, float or the string."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
            continue
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = v
    return out


def merge_out(path: str, results: list, failures: list) -> dict:
    """The payload to write to ``--out``: these results and failures, and
    the old file's records of other (arch, shape, variant, mesh) keys."""
    payload = {"results": results, "failures": failures}
    if not os.path.exists(path):
        return payload
    try:
        with open(path) as fh:
            old = json.load(fh)
    except (OSError, ValueError):
        return payload

    def keyf(r):
        return (r["arch"], r["shape"], r.get("variant", ""),
                tuple(sorted(r["mesh"].items())))
    seen = {keyf(r) for r in results}
    payload["results"] += [r for r in old.get("results", [])
                           if keyf(r) not in seen]
    ok = {(r["arch"], r["shape"]) for r in payload["results"]}
    fseen, merged = set(), []
    for f in payload["failures"] + old.get("failures", []):
        kk = (f["arch"], f["shape"])
        if kk in ok or kk in fseen:
            continue
        fseen.add(kk)
        merged.append(f)
    payload["failures"] = merged
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="", help="e.g. 4x4 or 2x4x4 "
                    "(default: 16x16, or 2x16x16 with --multi-pod)")
    ap.add_argument("--sparsifier", default="regtopk")
    ap.add_argument("--sparsity", type=float, default=0.001)
    ap.add_argument("--comm", default="sparse")
    ap.add_argument("--pipeline", default="reference",
                    choices=["reference", "fused"])
    ap.add_argument("--num-buckets", type=int, default=1,
                    help="bucketed compression and chunked sparse "
                         "collectives; 0 auto-tunes the count (the record "
                         "then carries the resolved value)")
    ap.add_argument("--selector", default="exact",
                    choices=["exact", "histogram"])
    ap.add_argument("--allocation", default="global",
                    choices=["global", "proportional", "adaptive"])
    ap.add_argument("--num-segments", type=int, default=0)
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--fault-schedule", default="",
                    help="the record then carries the parsed schedule, the "
                         "expected active-worker count and the gather's "
                         "wire at E[n_active]")
    ap.add_argument("--overlap", default="none",
                    choices=["none", "backward"])
    ap.add_argument("--err-decay", type=float, default=1.0)
    ap.add_argument("--sketch-rows", type=int, default=3)
    ap.add_argument("--sketch-width", type=int, default=0)
    ap.add_argument("--combine", default="mean",
                    choices=["mean", "support"])
    ap.add_argument("--delta-k", type=int, default=0,
                    help="the delta broadcast's budget: the record then "
                         "carries a delta's wire bytes, a resync's bytes "
                         "and their breakeven")
    ap.add_argument("--delta-fault-schedule", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--variant", default="")
    ap.add_argument("--state-format", default="dense")
    ap.add_argument("--ef-dtype", default="float32")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. mla_absorb=true)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
    else:
        dims = (2, 16, 16) if args.multi_pod else (16, 16)
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    results, failures = [], []
    for a in archs:
        for s in shapes:
            try:
                results.append(dryrun_one(
                    a, s, dims, variant=args.variant,
                    delta_k=args.delta_k,
                    delta_fault_schedule=args.delta_fault_schedule,
                    sparsifier=args.sparsifier, sparsity=args.sparsity,
                    comm=args.comm, state_format=args.state_format,
                    ef_dtype=args.ef_dtype, pipeline=args.pipeline,
                    num_buckets=args.num_buckets, selector=args.selector,
                    wire_dtype=args.wire_dtype, allocation=args.allocation,
                    num_segments=args.num_segments,
                    fault_schedule=args.fault_schedule,
                    err_decay=args.err_decay, combine=args.combine,
                    overlap=args.overlap, sketch_rows=args.sketch_rows,
                    sketch_width=args.sketch_width, **overrides))
            except Exception as e:  # noqa: BLE001 (report every combination)
                import traceback
                traceback.print_exc()
                failures.append({"arch": a, "shape": s, "error": repr(e)})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        payload = merge_out(args.out, results, failures)
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
    print(f"\n{len(results)} ok, {len(failures)} failed")
    for f in failures:
        print("FAIL:", f["arch"], f["shape"], f["error"][:200])
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
