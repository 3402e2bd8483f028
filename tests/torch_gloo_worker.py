"""One rank of a gloo process group running the port (driven by
tests/test_torch_aggregate.py and tests/test_torch_checkpoint.py).

    python tests/torch_gloo_worker.py MODE RANK WORLD INIT_FILE IN.npz OUT.npz

MODE "sync" runs GradientSync over a fixed gradient stream; MODE "train"
runs the data-parallel train step (ZeRO-1 slice + all-gather) on this
rank's fixed batch; MODE "elastic" runs GradientSync under the fault
schedule of the inputs, once with sparse comm on the fused pipeline
(Gaussian gradients) and once with simulate comm on the reference
pipeline (dyadic gradients), each rank drawing its own participation
bits; MODE "baselines" runs GradientSync for each case the inputs list
(JSON: name -> [SparsifierConfig fields, whether the rank passes its
participation bit]), each rank taking its bit from the inputs; MODE
"checkpoint" takes one train step, then saves the group's checkpoint and
restores it at the same world; MODE "world_train" runs each case of the
inputs (JSON: sparsifier fields, fault schedule) through the train step
from the inputs' flat parameters, the rank taking its rows of the
global batch; MODE "launch" runs the train launcher's ``main()`` with
the inputs' flags inside the group, then ``train()`` with the group on
the same config; MODE "world_serve" runs each case of the inputs (JSON,
as tests/jax_mesh_worker.py's mode "serve" reads it) through the serve
step's builders over the group; MODE "recurrent_serve" serves a
data-parallel batch of the inputs' reduced ``arch`` (an SSM or hybrid
model) through the builders, and decodes a one-rank prefill's cache that
``shard_decode_cache`` cut by rows; MODE "encdec_serve" serves the
inputs' reduced encoder-decoder ``arch`` with the inputs' frames: a
data-parallel batch through the builders, and context-parallel decode of
one row from a one-rank prefill's cache that ``shard_decode_cache``
split by slots; MODE "collectives" runs the model group's collectives
forward and backward on the inputs' per-rank x and cotangents; MODE
"tp_train" and MODE "tp_serve" run each case of the inputs (JSON, as
tests/jax_mesh_worker.py's modes of those names read them) on the case's
(data, model) groups from this rank's share of the reference's global
parameters (a case with ``ckpt`` also checkpoints, restores and
publishes deltas of the joined parameters); MODE "ring_equal" runs ring
attention with every model rank holding one device's attention weights
beside that device's loss; MODE "tp_launch" runs both launchers'
``main()`` with the inputs' flags; MODE "cp_serve" decodes each case of
the inputs (JSON, as tests/jax_mesh_worker.py's mode "cp" reads it)
context-parallel on the case's (data, model) groups from a one-rank
prefill's cache that ``shard_decode_cache`` cut; MODE "group_delta" runs
a group applier over each case's groups (JSON: mesh, stream) on the
spool tests/jax_mesh_worker.py's mode "delta" wrote, rank 0 reading it
through a ``GroupChannel``, and checks that single reader against a
spool file written between two reads. Imports torch and the port only,
and records whether jax was imported.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.core import sparsify  # noqa: E402
from repro_torch.core.aggregate import GradientSync  # noqa: E402
from repro_torch.core.flatten import TreeFlattener, tree_map  # noqa: E402


def sparsifier(data) -> cfgs.SparsifierConfig:
    """The config of the inputs; pipeline and comm_mode default to the
    fused pipeline's sparse comm."""
    def opt(key, default):
        return str(data[key]) if key in data else default
    return cfgs.SparsifierConfig(kind=str(data["kind"]),
                                 sparsity=float(data["sparsity"]),
                                 mu=float(data["mu"]),
                                 pipeline=opt("pipeline", "fused"),
                                 comm_mode=opt("comm_mode", "sparse"))


def run_sync(rank: int, data) -> dict:
    grads = data["grads"]                           # (T, world, J)
    cfg = sparsifier(data)
    sync = GradientSync(cfg)
    state = sparsify.init_state(cfg, grads.shape[2], "cpu")
    res = {}
    for t in range(grads.shape[0]):
        g_agg, state = sync(state, torch.from_numpy(grads[t, rank]))
        res[f"g_agg_{t}"] = g_agg.numpy()
    for key, val in state.items():
        res[f"state_{key}"] = val.numpy()
    return res


ELASTIC = {"sparse": dict(pipeline="fused", comm_mode="sparse"),
           "simulate": dict(pipeline="reference", comm_mode="simulate")}


def run_elastic(rank: int, data) -> dict:
    """For each of ELASTIC's configs (kind, err_decay from the inputs):
    per step g_agg and n_active, and the final state."""
    from repro_torch.core import faults
    sched = faults.parse_schedule(str(data["schedule"]))
    res = {}
    for name, fields in ELASTIC.items():
        cfg = cfgs.SparsifierConfig(kind=str(data["kind"]),
                                    sparsity=float(data["sparsity"]),
                                    mu=float(data["mu"]),
                                    err_decay=float(data["err_decay"]),
                                    **fields)
        grads = data[f"grads_{name}"]                # (T, world, J)
        sync = GradientSync(cfg)
        state = sparsify.init_state(cfg, grads.shape[2], "cpu")
        for t in range(grads.shape[0]):
            part = faults.participates(sched, state["step"], rank)
            g_agg, state, stats = sync(
                state, torch.from_numpy(grads[t, rank]), participate=part,
                with_stats=True)
            res[f"{name}_g_agg_{t}"] = g_agg.numpy()
            res[f"{name}_n_active_{t}"] = stats["n_active"].numpy()
            res[f"{name}_part_{t}"] = part.numpy()
        for key, val in state.items():
            res[f"{name}_state_{key}"] = val.numpy()
    return res


def _saved(t: torch.Tensor) -> np.ndarray:
    """A tensor as np.savez keeps it: bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def run_baselines(rank: int, data) -> dict:
    """Per case: g_agg and n_active of every step, the final state (bf16
    as uint16 bits)."""
    grads, parts = data["grads"], data["parts"]     # (T, world, J), (T, world)
    if "auto_buckets" in data.files:
        # the collective launch floor the test sets (the H100's constants)
        from repro_torch.roofline import analysis
        analysis.COLLECTIVE_LATENCY_S = json.loads(
            str(data["auto_buckets"]))[-1]
    res = {}
    for name, (fields, elastic) in json.loads(str(data["cases"])).items():
        cfg = cfgs.SparsifierConfig(sparsity=float(data["sparsity"]),
                                    mu=float(data["mu"]), **fields)
        sync = GradientSync(cfg)
        state = sparsify.init_state(cfg, grads.shape[2], "cpu")
        for t in range(grads.shape[0]):
            part = torch.tensor(bool(parts[t, rank])) if elastic else None
            g_agg, state, stats = sync(
                state, torch.from_numpy(grads[t, rank].copy()),
                participate=part, with_stats=True)
            res[f"{name}_g_agg_{t}"] = _saved(g_agg)
            res[f"{name}_n_active_{t}"] = stats["n_active"].numpy()
        for key, val in state.items():
            res[f"{name}_state_{key}"] = _saved(val)
        if cfg.num_buckets == 0:          # the count the sync resolved
            res[f"{name}_num_buckets"] = np.asarray(sync.cfg.num_buckets)
    return res


def train_run(data) -> cfgs.RunConfig:
    """The run both the gloo ranks and the in-process emulation use."""
    return cfgs.RunConfig(
        model=cfgs.reduced_config(cfgs.get_config("stablelm-3b")),
        shape=cfgs.SHAPES["train_4k"], sparsifier=sparsifier(data),
        optimizer=cfgs.OptimizerConfig(kind="adam", lr=1e-3), seed=0,
        steps=int(data["steps"]))


def run_train(rank: int, data) -> dict:
    from repro_torch.train.step import build_train_step, init_train_state
    run = train_run(data)
    state = init_train_state(run, "cpu")
    step = build_train_step(run, "cpu")
    batch = {"tokens": torch.from_numpy(data["tokens"][rank]),
             "targets": torch.from_numpy(data["targets"][rank])}
    losses = []
    for _ in range(run.steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    flat = TreeFlattener(state.params).flatten(state.params)
    return {"params": flat.detach().numpy(), "losses": np.asarray(losses)}


def run_checkpoint(rank: int, data) -> dict:
    """One train step, then ``save_train_state`` over the group into
    ``data["ckpt"]`` and ``restore_train_state`` at the same world: the
    rank's state, and whether the restore equals it leaf for leaf."""
    from repro_torch.core.flatten import tree_items
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        restore_train_state,
                                        save_train_state)
    run = train_run(data)
    state = init_train_state(run, "cpu")
    batch = {"tokens": torch.from_numpy(data["tokens"][rank]),
             "targets": torch.from_numpy(data["targets"][rank])}
    state, _ = build_train_step(run, "cpu")(state, batch)
    save_train_state(str(data["ckpt"]), 1, state, param_version=1)
    back = restore_train_state(str(data["ckpt"]), 1, run, "cpu")
    res = {"restored_equal": np.asarray(all(
        x.dtype == y.dtype and torch.equal(x, y)
        for a, b in ((state.params, back.params), (state.opt, back.opt),
                     (state.ef, back.ef))
        for (_, x), (_, y) in zip(tree_items(a), tree_items(b))))}
    for name, tree in (("opt", state.opt), ("ef", state.ef)):
        for key, val in tree.items():
            res[f"{name}_{key}"] = _saved(val)
    return res


def _from_flat(model, flat) -> dict:
    """A parameter tree of ``model`` holding the flat vector ``flat``."""
    from repro_torch.models import init_params
    tmpl = init_params(model, torch.Generator(), "meta")
    return TreeFlattener(tmpl).unflatten(torch.from_numpy(flat))


def _rows(x, rank: int, world: int):
    rows = x.shape[0] // world
    return torch.from_numpy(x[rank * rows:(rank + 1) * rows]).long()


def run_world_train(rank: int, data) -> dict:
    """Per case: every step's metrics, the final flat parameters and the
    sorted ``idx_prev`` of this rank; the model is the inputs' reduced
    ``arch`` (default stablelm-3b)."""
    from repro_torch.train.step import build_train_step, init_train_state
    world = dist.get_world_size()
    batch = {"tokens": _rows(data["tokens"], rank, world),
             "targets": _rows(data["targets"], rank, world)}
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        run = cfgs.RunConfig(
            model=cfgs.reduced_config(cfgs.get_config(
                str(data["arch"]) if "arch" in data else "stablelm-3b")),
            shape=cfgs.SHAPES["train_4k"],
            sparsifier=cfgs.SparsifierConfig(**case["sparsifier"]),
            optimizer=cfgs.OptimizerConfig(kind="adam", lr=1e-3), seed=0,
            steps=int(data["steps"]), fault_schedule=case.get("schedule",
                                                              ""))
        params = _from_flat(run.model, data["init_params"])
        state = init_train_state(run, "cpu", params=params)
        step = build_train_step(run, "cpu")
        for t in range(run.steps):
            state, metrics = step(state, batch)
            for key, val in metrics.items():
                res[f"{name}_{key}_{t}"] = val.numpy()
        res[f"{name}_params"] = TreeFlattener(state.params).flatten(
            state.params).detach().numpy()
        if "idx_prev" in state.ef:
            res[f"{name}_idx_prev"] = np.sort(
                state.ef["idx_prev"].numpy().view(np.uint32))
    return res


def run_launch(rank: int, data) -> dict:
    """The launcher's main() with the inputs' flags, the group already
    joined (as a caller of main() may have), recording each step's batch
    and loss; then train() with the group on the run the same flags
    make."""
    from repro_torch.launch import train as launcher
    from repro_torch.train.step import TrainStep
    flags = [str(f) for f in data["flags"]]
    seen, losses = [], []
    call = TrainStep.__call__

    def spy(self, state, batch):
        seen.append(batch["tokens"].clone())
        state, metrics = call(self, state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics
    TrainStep.__call__ = spy
    try:
        launcher.main(flags)
    finally:
        TrainStep.__call__ = call
    args = launcher.parse_args(flags)
    out = launcher.train(launcher.run_config(args), device="cpu",
                         group=dist.group.WORLD, batch=args.batch,
                         seq=args.seq, fixed_batch=args.fixed_batch,
                         log=lambda msg: None)
    return {"tokens": torch.stack(seen).numpy(),
            "losses": np.asarray(losses),
            "train_losses": np.asarray([r["loss"] for r in out["history"]])}


def run_world_serve(rank: int, data) -> dict:
    """Per case: the prefill's gathered logits (data-parallel) and every
    decode step's logits, through the builders of ``serve.step`` over
    the group; a context-parallel case decodes a one-rank prefill's cache
    that ``shard_decode_cache`` split over the group."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    from repro_torch.serve.step import (build_decode_step, build_prefill,
                                        serve_parallel, shard_decode_cache)
    world = dist.get_world_size()
    group = dist.group.WORLD
    base = cfgs.reduced_config(cfgs.get_config("granite-8b"))
    params = _from_flat(base, data["init_params"])
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        if case["world"] != world:
            continue
        model = base if case["attn"] == "full" else dataclasses.replace(
            base, attn_kind="sliding", window=int(data["window"]))
        b, prompt, seq = case["batch"], case["prompt"], case["seq"]
        run = cfgs.RunConfig(model=model, shape=cfgs.ShapeConfig(
            "serve", seq, b, "decode"),
            sparsifier=cfgs.SparsifierConfig(kind="none"))
        tokens = torch.from_numpy(data["tokens"][:b]).long()
        dec = build_decode_step(run, "cpu", group=group)
        if case["cp"]:
            with torch.inference_mode():
                _, cache = tfm.prefill(params, {"tokens": tokens[:, :prompt]},
                                       model, max_seq=seq)
            cache = shard_decode_cache(cache, run, group)
        else:
            pre = build_prefill(run, "cpu", group=group)
            logits, cache = pre(params, {"tokens": tokens[:, :prompt]})
            res[f"{name}_prefill"] = logits.numpy()
        res[f"{name}_cache_slots"] = np.asarray(
            cache["blocks"]["l0"]["k"].shape[1:3])
        zeros = tfm.init_decode_cache(
            model, b if case["cp"] else b // world, seq, torch.float32,
            "cpu", serve_parallel(run, group, decode=True))
        res[f"{name}_init_slots"] = np.asarray(
            zeros["blocks"]["l0"]["k"].shape[1:3])
        for t in range(prompt, tokens.shape[1]):
            logits, cache = dec(params, cache, tokens[:, t:t + 1])
            res[f"{name}_decode_{t - prompt}"] = logits.numpy()
    res["raises"] = np.asarray([_raises(build_prefill, base, b, seq, group)
                                for b, seq in data["raise_cases"]])
    return res


def run_recurrent_serve(rank: int, data) -> dict:
    """The gathered prefill logits and every decode step's, from the
    builders' own prefill and from this rank's rows of a one-rank
    prefill's cache (``shard_decode_cache``), with the shapes of this
    rank's cache leaves."""
    from repro_torch.core.flatten import tree_items
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.step import (build_decode_step, build_prefill,
                                        shard_decode_cache)
    group = dist.group.WORLD
    model = cfgs.reduced_config(cfgs.get_config(str(data["arch"])))
    params = _from_flat(model, data["init_params"])
    tokens = torch.from_numpy(data["tokens"]).long()
    prompt = int(data["prompt"])
    run = cfgs.RunConfig(model=model, shape=cfgs.ShapeConfig(
        "serve", tokens.shape[1], tokens.shape[0], "decode"),
        sparsifier=cfgs.SparsifierConfig(kind="none"))
    logits, cache = build_prefill(run, "cpu", group=group)(
        params, {"tokens": tokens[:, :prompt]})
    with torch.inference_mode():
        _, whole = tfm.prefill(params, {"tokens": tokens[:, :prompt]}, model,
                               max_seq=tokens.shape[1])
    res = {"prefill": logits.numpy()}
    for path, leaf in tree_items(cache["blocks"]):
        res["shape_" + "_".join(map(str, path))] = np.asarray(leaf.shape)
    dec = build_decode_step(run, "cpu", group=group)
    for name, start in (("own", cache),
                        ("cut", shard_decode_cache(whole, run, group))):
        for t in range(prompt, tokens.shape[1]):
            step_logits, start = dec(params, start, tokens[:, t:t + 1])
            res[f"{name}_decode_{t - prompt}"] = step_logits.numpy()
    return res


def run_encdec_serve(rank: int, data) -> dict:
    """Data-parallel ("dp", the inputs' whole batch): the builders'
    gathered prefill logits and every decode step's; context-parallel
    ("cp", the first row): every decode step's logits from a one-rank
    prefill's cache that ``shard_decode_cache`` split over the group;
    each with the shapes of this rank's first self-attention and cross
    k."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.step import (build_decode_step, build_prefill,
                                        shard_decode_cache)
    group = dist.group.WORLD
    model = cfgs.reduced_config(cfgs.get_config(str(data["arch"])))
    params = _from_flat(model, data["init_params"])
    tokens = torch.from_numpy(data["tokens"]).long()
    frames = torch.from_numpy(data["frames"])
    prompt = int(data["prompt"])
    res = {}
    for name, b in (("dp", tokens.shape[0]), ("cp", 1)):
        run = cfgs.RunConfig(model=model, shape=cfgs.ShapeConfig(
            "serve", tokens.shape[1], b, "decode"),
            sparsifier=cfgs.SparsifierConfig(kind="none"))
        batch = {"tokens": tokens[:b, :prompt], "frames": frames[:b]}
        if name == "dp":
            logits, cache = build_prefill(run, "cpu", group=group)(params,
                                                                   batch)
            res["dp_prefill"] = logits.numpy()
        else:
            with torch.inference_mode():
                _, whole = tfm.prefill(params, batch, model,
                                       max_seq=tokens.shape[1])
            cache = shard_decode_cache(whole, run, group)
        res[f"{name}_self_k"] = np.asarray(cache["blocks"]["l0"]["k"].shape)
        res[f"{name}_cross_k"] = np.asarray(cache["cross"]["k"].shape)
        dec = build_decode_step(run, "cpu", group=group)
        for t in range(prompt, tokens.shape[1]):
            logits, cache = dec(params, cache, tokens[:b, t:t + 1])
            res[f"{name}_decode_{t - prompt}"] = logits.numpy()
    return res


def _raises(build_prefill, model, batch: int, seq: int, group) -> bool:
    """Whether the builders refuse a run of ``batch`` rows and ``seq``
    positions over the group with ValueError."""
    from repro_torch.serve.step import build_decode_step
    run = cfgs.RunConfig(model=model, shape=cfgs.ShapeConfig(
        "serve", int(seq), int(batch), "decode"),
        sparsifier=cfgs.SparsifierConfig(kind="none"))
    build = build_prefill if batch >= dist.get_world_size() else \
        build_decode_step
    try:
        build(run, "cpu", group=group)
    except ValueError:
        return True
    return False


def run_collectives(rank: int, data) -> dict:
    """Each model-group collective of ``models.parallel`` on this rank's
    x: its output and the gradient of this rank's cotangent (the world is
    one model group)."""
    from repro_torch.models import parallel as par
    pal = par.Parallel(group=dist.new_group([rank]),
                       model_group=dist.group.WORLD)
    fns = {"psum": lambda x: par.psum_model(x, pal),
           "all_gather": lambda x: par.all_gather_model(x, pal, 1),
           "psum_scatter": lambda x: par.psum_scatter_model(x, pal, 1),
           "all_to_all": lambda x: par.all_to_all_model(x, pal, 0, 1),
           "pmax": lambda x: x * par.pmax_model(x, pal),
           "ppermute": lambda x: par.ppermute_model(x, pal, 1),
           "ppermute_back": lambda x: par.ppermute_model(x, pal, -1)}
    res = {}
    for name, fn in fns.items():
        if f"ct_{name}" not in data:
            continue
        x = torch.from_numpy(data["x"][rank]).requires_grad_(True)
        y = fn(x)
        (gx,) = torch.autograd.grad(y, x, torch.from_numpy(
            data[f"ct_{name}"][rank]))
        res[f"{name}_y"], res[f"{name}_gx"] = y.detach().numpy(), gx.numpy()
    return res


def _tp_model(case: dict):
    """A case's reduced model (tests/jax_mesh_worker.py's ``_tp_model``)."""
    import dataclasses
    cfg = cfgs.reduced_config(cfgs.get_config(case["arch"]))
    if "heads" in case:
        cfg = dataclasses.replace(cfg, n_heads=case["heads"][0],
                                  n_kv_heads=case["heads"][1])
    if "vocab" in case:
        cfg = dataclasses.replace(cfg, vocab_size=case["vocab"])
    if case.get("attn") == "sliding":
        cfg = dataclasses.replace(cfg, attn_kind="sliding",
                                  window=int(case["window"]))
    if case.get("mla"):
        cfg = dataclasses.replace(cfg, attn_kind="mla", kv_lora_rank=32,
                                  rope_head_dim=16, v_head_dim=32)
    if case.get("absorb"):
        cfg = dataclasses.replace(cfg, mla_absorb=True)
    return cfg


def _global_tree(data, prefix: str) -> dict:
    """The reference's tree saved under ``prefix/path`` keys, as tensors
    (a list index as an int)."""
    from repro_torch.convert import _to_tensor
    from repro_torch.core.flatten import tree_from_items
    items = []
    for key in data.files:
        if key.startswith(prefix + "/"):
            path = tuple(int(k) if k.isdigit() else k
                         for k in key[len(prefix) + 1:].split("/"))
            items.append((path, _to_tensor(data[key], "cpu")))
    return tree_from_items(items)


def _axes(case: dict):
    """(data group, model group, data index, model index) of this rank on
    the case's (data, model) mesh."""
    from repro_torch.launch.mesh import axis_groups
    data_n, model = case["mesh"]
    group, model_group = axis_groups(data_n, model)
    rank = dist.get_rank()
    return group, model_group, rank // model, rank % model


def _replicated(params) -> np.ndarray:
    """This rank's leaves replicated over the model group, flat in leaf
    order."""
    from repro_torch.core.flatten import tree_items
    from repro_torch.models.specs import leaf_dim
    return torch.cat([leaf.detach().reshape(-1)
                      for path, leaf in tree_items(params)
                      if leaf_dim(path, leaf.ndim) is None]).numpy()


def _stubs(cfg, data, rows) -> dict:
    """The inputs' stub array of the model's frontend (``patches`` or
    ``frames``), its rows ``rows``, as a tensor; {} without a stub."""
    key = {"vision_stub": "patches", "audio_stub": "frames"}.get(
        cfg.frontend)
    return {} if key is None else {key: torch.from_numpy(
        np.ascontiguousarray(data[key][rows]))}


def run_tp_train(rank: int, data) -> dict:
    """Per case (tests/jax_mesh_worker.py's "tp_train" cases): this
    rank's share of the reference's initial parameters, STEPS steps of
    the train step over the case's data and model groups on the data
    rank's rows (and stub inputs; ring attention with the case's
    ``attn_dist``): every step's metrics and this rank's sorted
    ``idx_prev``, its copy of the replicated leaves, and the final
    parameters gathered into the global layout (flat); a case with
    ``ckpt`` also runs :func:`tp_checkpoint`."""
    from repro_torch.convert import join_params, split_params
    from repro_torch.train.step import build_train_step, init_train_state
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        group, model_group, d, m = _axes(case)
        data_n, model = case["mesh"]
        dist_ = case.get("attn_dist", "sp")
        run = cfgs.RunConfig(
            model=_tp_model(case), shape=cfgs.SHAPES["train_4k"],
            sparsifier=cfgs.SparsifierConfig(**case["sparsifier"]),
            optimizer=cfgs.OptimizerConfig(kind="adam", lr=1e-3,
                                           **case.get("optimizer", {})),
            seed=0, steps=int(data["steps"]))
        params = split_params(_global_tree(data, f"{name}_init"), model, m)
        state = init_train_state(run, "cpu", group, params=params,
                                 model_group=model_group)
        step = build_train_step(run, "cpu", group, model_group, dist_)
        n = data["tokens"].shape[0] // data_n
        batch = {"tokens": _rows(data["tokens"], d, data_n),
                 "targets": _rows(data["targets"], d, data_n),
                 **_stubs(run.model, data, slice(d * n, (d + 1) * n))}
        if case.get("ckpt"):
            res.update(tp_checkpoint(name, case, run, data, batch, group,
                                     model_group))
        for t in range(run.steps):
            state, metrics = step(state, batch)
            for key, val in metrics.items():
                res[f"{name}_{key}_{t}"] = val.numpy()
            res[f"{name}_idx_prev_{t}"] = np.sort(
                state.ef["idx_prev"].numpy().view(np.uint32))
        res[f"{name}_idx_prev"] = res[f"{name}_idx_prev_{run.steps - 1}"]
        res[f"{name}_replicated"] = _replicated(state.params)
        every = [None] * model
        dist.all_gather_object(every, tree_map(
            lambda t: t.detach(), state.params), group=model_group)
        glob = join_params(every)
        res[f"{name}_params"] = TreeFlattener(glob).flatten(
            glob).detach().numpy()
    return res


def _states_equal(a, b) -> bool:
    """Whether two TrainStates hold the same bits, leaf by leaf."""
    from repro_torch.core.flatten import tree_items
    return all(x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
               for p, q in ((a.params, b.params), (a.opt, b.opt),
                            (a.ef, b.ef))
               for (_, x), (_, y) in zip(tree_items(p), tree_items(q)))


def tp_checkpoint(name: str, case: dict, run, data, batch, group,
                  model_group) -> dict:
    """A "tp_train" case's checkpoints and deltas under the case's
    groups (and its ``attn_dist``): from the reference's initial parameters one step, then
    ``save_train_state`` of it (``<ckpt>_port``) and its restore, equal
    bit for bit; the live and the restored state each take two more
    steps, equal bit for bit; the reference's checkpoint after step 0
    (``<ckpt>``) restored and saved again (``<ckpt>_again``, which the
    test holds against the reference's file); and a ``DeltaPublisher``
    on the joined reference parameters before every step
    (``joined_params``), whose payloads rank 0 returns."""
    from repro_torch.convert import split_params
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        joined_params, restore_train_state,
                                        save_train_state)
    from repro_torch.serve.delta import DeltaPublisher
    _, m = dist.get_world_size(model_group), dist.get_rank(model_group)
    tp = case["mesh"][1]
    ckpt = case["ckpt"]
    step = build_train_step(run, "cpu", group, model_group,
                            case.get("attn_dist", "sp"))
    params = split_params(_global_tree(data, f"{name}_init"), tp, m)
    state = init_train_state(run, "cpu", group, params=params,
                             model_group=model_group)
    state, _ = step(state, batch)
    save_train_state(ckpt + "_port", 1, state, group, param_version=1,
                     model_group=model_group)
    back = restore_train_state(ckpt + "_port", 1, run, "cpu", group,
                               model_group)
    res = {f"{name}_restored_equal": np.asarray(_states_equal(state, back))}
    for _ in range(2):
        state, _ = step(state, batch)
        back, _ = step(back, batch)
    res[f"{name}_continued_equal"] = np.asarray(_states_equal(state, back))
    again = restore_train_state(ckpt, 1, run, "cpu", group, model_group)
    save_train_state(ckpt + "_again", 1, again, group, param_version=1,
                     model_group=model_group)
    pub = None
    for t in range(-1, int(data["steps"])):
        prefix = f"{name}_init" if t < 0 else f"{name}_step{t}"
        local = split_params(_global_tree(data, prefix), tp, m)
        joined = joined_params(local, model_group)
        if joined is None:
            continue
        if pub is None:
            pub = DeltaPublisher(joined, case["delta_k"])
            continue
        pay = pub.publish(joined)
        for key in ("values", "indices", "checksum"):
            res[f"{name}_delta{pay.version}_{key}"] = np.asarray(
                getattr(pay, key))
    return res


def run_ring_equal(rank: int, data) -> dict:
    """Per case (tests/jax_mesh_worker.py's "ring_equal" cases): the
    reference's one-device parameters, their loss on this rank alone,
    and the loss of ring attention over the case's groups (the model
    group's sum of the shares) with every model rank holding those
    attention weights whole and its share of the other leaves."""
    import dataclasses

    from repro_torch.convert import split_params
    from repro_torch.core.flatten import tree_from_items, tree_items
    from repro_torch.models import loss_fn
    from repro_torch.models.parallel import Parallel
    from repro_torch.models.specs import leaf_dim
    from repro_torch.models.transformer import global_loss
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        group, model_group, d, m = _axes(case)
        tp = case["mesh"][1]
        cfg = _tp_model(dict(case, window=case.get("window", 0)))
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=16.0, load_balance_loss=0.0))
        one = _global_tree(data, f"{name}_one")
        tiled = tree_from_items(
            (path, torch.cat([leaf] * tp, dim)
             if dim is not None and path[-2] in ("attn", "cross") else leaf)
            for path, leaf in tree_items(one)
            for dim in [leaf_dim(path, leaf.ndim)])
        params = split_params(tiled, tp, m)
        batch = {"tokens": torch.from_numpy(data["tokens"]).long(),
                 "targets": torch.from_numpy(data["targets"]).long()}
        pal = Parallel(group=group, model_group=model_group,
                       seq_parallel=True, attn_dist="ring")
        with torch.no_grad():
            res[f"{name}_ring_loss"] = global_loss(
                loss_fn(params, batch, cfg, pal), pal).numpy()
            res[f"{name}_one_loss"] = loss_fn(one, batch, cfg).numpy()
    return res


def run_tp_serve(rank: int, data) -> dict:
    """Per case (tests/jax_mesh_worker.py's "tp_serve" cases): this
    rank's share of the reference's parameters, the serve step's
    builders over the case's groups: the gathered prefill logits, this
    rank's cache after the prefill and the same device's shard of the
    reference's cache, and every decode step's logits (teacher
    forcing)."""
    from repro_torch.convert import split_params
    from repro_torch.core.flatten import tree_items
    from repro_torch.serve.step import build_decode_step, build_prefill
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        group, model_group, _, m = _axes(case)
        model = case["mesh"][1]
        cfg = _tp_model(dict(case, window=data["window"]))
        b, prompt, seq = case["batch"], case["prompt"], case["seq"]
        run = cfgs.RunConfig(model=cfg, shape=cfgs.ShapeConfig(
            "serve", seq, b, "decode"),
            sparsifier=cfgs.SparsifierConfig(kind="none"))
        params = split_params(_global_tree(data, f"{name}_init"), model, m)
        tokens = torch.from_numpy(data["tokens"][:b]).long()
        pre = build_prefill(run, "cpu", group=group, model_group=model_group)
        stubs = _stubs(cfg, {key[6:]: data[key] for key in data.files
                             if key.startswith("serve_")}, slice(0, b))
        logits, cache = pre(params, {"tokens": tokens[:, :prompt], **stubs})
        res[f"{name}_prefill"] = logits.numpy()
        want = _global_tree(data, f"{name}_shard{rank}")
        for path, leaf in tree_items(cache):
            key = "_".join(map(str, path))
            res[f"{name}_cache_{key}"] = leaf.numpy().copy()
            res[f"{name}_want_{key}"] = leaf_at(want, path).numpy()
        dec = build_decode_step(run, "cpu", group=group,
                                model_group=model_group)
        for t in range(prompt, tokens.shape[1]):
            logits, cache = dec(params, cache, tokens[:, t:t + 1])
            res[f"{name}_decode_{t - prompt}"] = logits.numpy()
    return res


def run_cp_serve(rank: int, data) -> dict:
    """Per case (tests/jax_mesh_worker.py's "cp" cases): every decode
    step's logits, this rank's cache shapes, and after the last step its
    recurrent leaves (every leaf but the attention cache's), flat in
    tree order."""
    from repro_torch.convert import split_params
    from repro_torch.core.flatten import tree_items
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.step import build_decode_step, shard_decode_cache
    models = json.loads(str(data["models"]))
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        group, model_group, _, m = _axes(case)
        tp = case["mesh"][1]
        cfg = _tp_model(models[case["model"]])
        b, prompt, seq = case["batch"], case["prompt"], case["seq"]
        run = cfgs.RunConfig(model=cfg, shape=cfgs.ShapeConfig(
            "serve", seq, b, "decode"),
            sparsifier=cfgs.SparsifierConfig(kind="none"))
        whole = _global_tree(data, f"{case['model']}_init")
        tokens = torch.from_numpy(data["tokens"][:b]).long()
        with torch.inference_mode():
            _, cache = tfm.prefill(whole, {"tokens": tokens[:, :prompt]},
                                   cfg, max_seq=seq)
        cache = shard_decode_cache(cache, run, group, model_group)
        params = split_params(whole, tp, m) if tp > 1 else whole
        for path, leaf in tree_items(cache):
            res[f"{name}_shape_" + "_".join(map(str, path))] = \
                np.asarray(leaf.shape)
        dec = build_decode_step(run, "cpu", group=group,
                                model_group=model_group)
        for t in range(prompt, tokens.shape[1]):
            logits, cache = dec(params, cache, tokens[:, t:t + 1])
            res[f"{name}_decode_{t - prompt}"] = logits.numpy()
        state = [leaf.reshape(-1) for path, leaf in tree_items(cache)
                 if path != ("pos",) and path[-1] not in attn.CACHE_KEYS]
        res[f"{name}_state"] = (torch.cat(state).numpy() if state
                                else np.zeros(0, np.float32))
    return res


class _WritesBetweenReads:
    """A spool reader that, right after it reads, puts the next file of
    ``pending`` into the spool: a trainer writing between two ranks'
    reads."""

    def __init__(self, inner, spool: str, pending: list):
        self.inner, self.spool, self.pending = inner, spool, pending

    def recv(self) -> list:
        import shutil
        out = self.inner.recv()
        if self.pending:
            shutil.copy(self.pending.pop(0), self.spool)
        return out


def run_group_delta(rank: int, data) -> dict:
    """Per case (JSON: mesh, stream; tests/test_torch_group_delta.py):
    the group applier from the stream's version-0 snapshot, one spool
    file a tick read by rank 0 through ``FaultyChannel(SpoolChannel)``
    and a ``GroupChannel``, resyncing after a gap as ``launch.serve``
    does: every verdict, the counters, the version and this rank's tree
    after every tick, the pinned tree before and after, the payloads'
    versions as this rank received them. Then the single reader against
    a spool file written between two reads: each rank's received
    versions, through a ``GroupChannel`` and through a reader of its
    own."""
    import shutil

    from repro_torch.core import faults
    from repro_torch.core.flatten import tree_items
    from repro_torch.serve import delta as dl
    from repro_torch.serve.step import delta_applier_from_snapshot
    res = {}
    streams = json.loads(str(data["streams"]))
    for name, case in json.loads(str(data["cases"])).items():
        group, model_group, _, _ = _axes(case)
        st = streams[case["stream"]]
        cfg = _tp_model(st["model"])
        run = cfgs.RunConfig(model=cfg, shape=cfgs.ShapeConfig(
            "serve", 16, 4, "decode"),
            sparsifier=cfgs.SparsifierConfig(kind="none"))
        snaps = os.path.join(st["root"], "snapshots")
        src = os.path.join(st["root"], "source")
        live = os.path.join(st["root"], f"{name}_spool")
        applier, pinned = delta_applier_from_snapshot(
            run, snaps, "cpu", step=0, group=group, model_group=model_group)
        before = [leaf.clone() for _, leaf in tree_items(pinned)]
        chan = None
        if rank == 0:
            chan = dl.FaultyChannel(dl.SpoolChannel(live),
                                    faults.parse_channel_schedule(
                                        st["schedule"]))
        chan = dl.GroupChannel(chan, group, model_group, "cpu")
        verdicts, seen = [], []

        def intake(payloads):
            seen.extend(p.version for p in payloads)
            for p in payloads:
                verdicts.append(applier.offer(p))
            if applier.needs_resync and applier.can_resync(snaps):
                applier.resync_from(snaps)
        files = sorted(f for f in os.listdir(src) if f.endswith(".npz"))
        for t, fname in enumerate(files):
            if rank == 0:
                shutil.copy(os.path.join(src, fname),
                            os.path.join(live, fname))
            intake(chan.recv())
            res.update({f"{name}_tick{t}/" + "/".join(map(str, path)):
                        leaf.numpy() for path, leaf in
                        tree_items(applier.params)})
            res[f"{name}_version_{t}"] = np.asarray(applier.version)
        intake(chan.flush())
        res.update({f"{name}_final/" + "/".join(map(str, path)):
                    leaf.numpy() for path, leaf in tree_items(applier.params)})
        res[f"{name}_verdicts"] = np.asarray(verdicts)
        res[f"{name}_seen"] = np.asarray(seen)
        res[f"{name}_metrics"] = np.asarray(json.dumps(applier.metrics()))
        res[f"{name}_pinned_unchanged"] = np.asarray(all(
            torch.equal(a, b) for a, (_, b) in zip(before,
                                                  tree_items(pinned))))
        dist.barrier()
    # the single reader: rank 0 reads, then a file lands before the
    # others would read: the group channel gives every rank rank 0's
    # read, readers of their own part ways
    root = str(data["race_root"])
    src = sorted(os.path.join(root, "source", f) for f in
                 os.listdir(os.path.join(root, "source")))
    got, mine = [], []
    for kind, out in (("group", got), ("own", mine)):
        spool = os.path.join(root, kind)
        if rank == 0:
            os.makedirs(spool, exist_ok=True)
            shutil.copy(src[0], spool)
        dist.barrier()
        reader = dl.SpoolChannel(spool)
        if kind == "group":
            reader = dl.GroupChannel(
                _WritesBetweenReads(reader, spool, src[1:]) if rank == 0
                else None, dist.group.WORLD, None, "cpu")
        elif rank == 0:
            reader = _WritesBetweenReads(reader, spool, src[1:])
        for _ in src:
            if kind == "group" or rank == 0:
                out.append([p.version for p in reader.recv()])
            dist.barrier()
            if kind == "own" and rank:
                out.append([p.version for p in reader.recv()])
            dist.barrier()
    res["race_group"] = np.asarray(json.dumps(got))
    res["race_own"] = np.asarray(json.dumps(mine))
    return res


def leaf_at(tree, path):
    """The leaf of ``tree`` at ``path``."""
    for key in path:
        tree = tree[key]
    return tree


def run_tp_launch(rank: int, data) -> dict:
    """Both launchers' ``main()`` with ``--model 2`` inside the group
    (the inputs' flags): the train launcher's step losses and the serve
    launcher's greedy tokens."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as launcher
    from repro_torch.train.step import TrainStep
    losses, served = [], []
    call = TrainStep.__call__

    def spy(self, state, batch):
        state, metrics = call(self, state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics
    serve = serve_launcher.serve

    def spy_serve(*args, **kwargs):
        out = serve(*args, **kwargs)
        served.append(out["tokens"].clone())
        return out
    TrainStep.__call__ = spy
    serve_launcher.serve = spy_serve
    try:
        launcher.main([str(f) for f in data["train_flags"]])
        serve_launcher.main([str(f) for f in data["serve_flags"]])
    finally:
        TrainStep.__call__ = call
        serve_launcher.serve = serve
    return {"losses": np.asarray(losses), "tokens": served[0].numpy()}


def main(mode: str, rank: int, world: int, init_file: str, inp: str,
         out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        data = np.load(inp)
        run = {"sync": run_sync, "train": run_train,
               "elastic": run_elastic, "baselines": run_baselines,
               "checkpoint": run_checkpoint,
               "world_train": run_world_train, "launch": run_launch,
               "world_serve": run_world_serve,
               "recurrent_serve": run_recurrent_serve,
               "encdec_serve": run_encdec_serve,
               "collectives": run_collectives, "tp_train": run_tp_train,
               "tp_serve": run_tp_serve, "ring_equal": run_ring_equal,
               "tp_launch": run_tp_launch, "cp_serve": run_cp_serve,
               "group_delta": run_group_delta}[mode]
        res = run(rank, data)
        res["jax_imported"] = np.asarray("jax" in sys.modules)
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
