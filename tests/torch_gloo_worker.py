"""One rank of a gloo process group running the port (driven by
tests/test_torch_aggregate.py).

    python tests/torch_gloo_worker.py MODE RANK WORLD INIT_FILE IN.npz OUT.npz

MODE "sync" runs GradientSync over a fixed gradient stream; MODE "train"
runs the data-parallel train step (ZeRO-1 slice + all-gather) on this
rank's fixed batch; MODE "elastic" runs GradientSync under the fault
schedule of the inputs, once with sparse comm on the fused pipeline
(Gaussian gradients) and once with simulate comm on the reference
pipeline (dyadic gradients), each rank drawing its own participation
bits; MODE "baselines" runs GradientSync for each case the inputs list
(JSON: name -> [SparsifierConfig fields, whether the rank passes its
participation bit]), each rank taking its bit from the inputs. Imports
torch and the port only, and records whether jax was imported.
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
from repro_torch.core.flatten import TreeFlattener  # noqa: E402


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


def run_baselines(rank: int, data) -> dict:
    """Per case: g_agg and n_active of every step, the final state."""
    grads, parts = data["grads"], data["parts"]     # (T, world, J), (T, world)
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
            res[f"{name}_g_agg_{t}"] = g_agg.numpy()
            res[f"{name}_n_active_{t}"] = stats["n_active"].numpy()
        for key, val in state.items():
            res[f"{name}_state_{key}"] = val.numpy()
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


def main(mode: str, rank: int, world: int, init_file: str, inp: str,
         out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        data = np.load(inp)
        run = {"sync": run_sync, "train": run_train,
               "elastic": run_elastic, "baselines": run_baselines}[mode]
        res = run(rank, data)
        res["jax_imported"] = np.asarray("jax" in sys.modules)
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
