"""One rank of a gloo process group running the port (driven by
tests/test_torch_aggregate.py).

    python tests/torch_gloo_worker.py MODE RANK WORLD INIT_FILE IN.npz OUT.npz

MODE "sync" runs GradientSync over a fixed gradient stream; MODE "train"
runs the data-parallel train step (ZeRO-1 slice + all-gather) on this
rank's fixed batch. Imports torch and the port only, and records whether
jax was imported.
"""
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
        res = run_sync(rank, data) if mode == "sync" else run_train(rank,
                                                                   data)
        res["jax_imported"] = np.asarray("jax" in sys.modules)
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
