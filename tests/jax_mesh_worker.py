"""The reference on a mesh of N host CPU devices (driven by
tests/test_torch_baselines_gloo.py, tests/test_torch_bucketed.py,
tests/test_torch_elastic.py, tests/test_torch_world_train.py and
tests/test_torch_world_serve.py, which hold the port's gloo ranks
against it).

    python tests/jax_mesh_worker.py WORLD IN.npz OUT.npz

The inputs' ``mode`` (default "sync") picks what runs:

- "sync": for each case the inputs list (JSON, as
  tests/torch_gloo_worker.py's mode "baselines" reads it), the per-step
  sync under ``shard_map`` over WORLD devices, each device one rank with
  its own gradient (the inputs' ``grads_<case>``, else ``grads``), state
  and participation bit: g_agg and n_active of every step and every
  rank's final state;
- "train": for each case (JSON: mesh shape, sparsifier fields, fault
  schedule), ``build_train_step`` on that mesh (a ``("data", "model")``
  or ``("pod", "data", "model")`` mesh of the first devices) over the
  global batch of the inputs: reduced StableLM-3B, Adam, the parameters
  drawn from key 0 (written once, flat), every step's metrics, the final
  flat parameters and each rank's ``idx_prev``;
- "serve": reduced Granite-8B (full attention, and sliding with the
  inputs' window), its parameters from key 0 (flat); for each case
  (JSON: world, batch, prompt and cache lengths, attention, and
  ``cp`` for context-parallel decode) the one-device ``prefill`` and
  ``decode_step`` and the mesh's ``build_prefill`` and
  ``build_decode_step`` (context-parallel: a one-device prefill's cache
  put on the mesh with ``decode_cache_specs``), fed the inputs' decode
  tokens: the logits of the prefill and of every decode step.

The device count is set before jax is imported, so this runs in a
process of its own.
"""
import json
import os
import sys

WORLD = int(sys.argv[1])
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           f" --xla_force_host_platform_device_count={WORLD}")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import SparsifierConfig  # noqa: E402
from repro.core import aggregate, sparsify  # noqa: E402


def run_case(mesh, fields: dict, elastic: bool, grads, parts) -> dict:
    cfg = SparsifierConfig(**fields)
    tmap = jax.tree_util.tree_map

    def f(g, st, p):
        st = tmap(lambda x: x[0], st)
        g_agg, new, stats = aggregate.GradientSync(cfg, ("data",))(
            st, g[0], participate=p[0] if elastic else None,
            with_stats=True)
        return (g_agg[None], tmap(lambda x: x[None], new),
                stats["n_active"][None])

    st = sparsify.stack_states([sparsify.init_state(cfg, grads.shape[2])
                                for _ in range(WORLD)])
    spec = tmap(lambda _: P("data"), st)
    fn = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("data"), spec, P("data")),
        out_specs=(P("data"), spec, P("data")), check_vma=False))
    res = {}
    with mesh:
        for t in range(grads.shape[0]):
            g_agg, st, na = fn(jnp.asarray(grads[t]), st,
                               jnp.asarray(parts[t]))
            res[f"g_agg_{t}"] = _saved(g_agg)
            res[f"n_active_{t}"] = np.asarray(na)
    for key, val in jax.device_get(st).items():
        res[f"state_{key}"] = _saved(val)
    return res


def _saved(val) -> np.ndarray:
    """An array as np.savez keeps it: bf16, which it has no type for, as
    its uint16 bits."""
    val = np.asarray(val)
    return val.view(np.uint16) if val.dtype.name == "bfloat16" else val


def _mesh(shape):
    names = (("pod", "data", "model") if len(shape) == 3
             else ("data", "model"))
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             names)


def _flat(tree) -> np.ndarray:
    from repro.core.flatten import TreeFlattener
    return np.asarray(TreeFlattener(tree).flatten(tree))


def run_train(data) -> dict:
    from repro.configs import base
    from repro.train.step import (build_parallel, build_train_step,
                                  init_train_state)
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "targets": jnp.asarray(data["targets"])}
    steps = int(data["steps"])
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        run = base.RunConfig(
            model=base.reduced_config(base.get_config("stablelm-3b")),
            shape=base.SHAPES["train_4k"],
            sparsifier=base.SparsifierConfig(**case["sparsifier"]),
            optimizer=base.OptimizerConfig(kind="adam", lr=1e-3), seed=0,
            steps=steps, fault_schedule=case.get("schedule", ""))
        mesh = _mesh(tuple(case["mesh"]))
        pal = build_parallel(mesh)
        with mesh:
            params, opt, ef = init_train_state(run, mesh, pal,
                                               jax.random.PRNGKey(0))
            if "init_params" not in res:
                res["init_params"] = _flat(jax.device_get(params))
            step, _, _ = build_train_step(run, mesh, pal)
            jstep = jax.jit(step)
            for t in range(steps):
                params, opt, ef, m = jstep(params, opt, ef, batch,
                                           jax.random.PRNGKey(0))
                for key, val in m.items():
                    res[f"{name}_{key}_{t}"] = np.asarray(val)
            res[f"{name}_params"] = _flat(jax.device_get(params))
            if "idx_prev" in ef:
                res[f"{name}_idx_prev"] = np.asarray(ef["idx_prev"])
    return res


def run_serve(data) -> dict:
    import dataclasses

    from repro.configs import base
    from repro.models import decode_step, init_params, prefill
    from repro.models.parallel import Parallel
    from repro.serve.step import (build_decode_step, build_prefill,
                                  decode_cache_specs, serve_parallel)
    from jax.sharding import NamedSharding
    cfg = base.reduced_config(base.get_config("granite-8b"))
    params = init_params(cfg, Parallel(), jax.random.PRNGKey(0))
    res = {"init_params": _flat(params)}
    for name, case in json.loads(str(data["cases"])).items():
        mcfg = cfg if case["attn"] == "full" else dataclasses.replace(
            cfg, attn_kind="sliding", window=int(data["window"]))
        b, prompt, seq = case["batch"], case["prompt"], case["seq"]
        run = base.RunConfig(
            model=mcfg, shape=base.ShapeConfig("serve", seq, b, "decode"),
            sparsifier=base.SparsifierConfig(kind="none"))
        tokens = jnp.asarray(data["tokens"][:b, :prompt])
        feed = data["tokens"][:b, prompt:]
        one = Parallel()
        lg, cache = jax.jit(lambda p, t: prefill(
            p, {"tokens": t}, mcfg, one, max_seq=seq))(params, tokens)
        res[f"{name}_one_prefill"] = np.asarray(lg)
        dec1 = jax.jit(lambda p, c, t: decode_step(p, c, t, mcfg, one))
        mesh = _mesh((case["world"], 1))
        pal = serve_parallel(mesh, run, decode=True)
        assert (pal.cache_seq_axis is not None) == case["cp"], name
        with mesh:
            dec, _ = build_decode_step(run, mesh, pal)
            dec = jax.jit(dec)
            if case["cp"]:
                _, cspecs, _, _ = decode_cache_specs(run, mesh, pal)
                mcache = jax.device_put(cache, jax.tree_util.tree_map(
                    lambda s: NamedSharding(mesh, s), cspecs))
            else:
                pre, _ = build_prefill(run, mesh, pal)
                mlg, mcache = jax.jit(pre)(params, {"tokens": tokens})
                res[f"{name}_mesh_prefill"] = np.asarray(mlg)
            for t in range(feed.shape[1]):
                tok = jnp.asarray(feed[:, t:t + 1])
                lg, cache = dec1(params, cache, tok)
                res[f"{name}_one_decode_{t}"] = np.asarray(lg)
                mlg, mcache = dec(params, mcache, tok)
                res[f"{name}_mesh_decode_{t}"] = np.asarray(mlg)
    return res


def main(inp: str, out: str) -> None:
    data = np.load(inp)
    mode = str(data["mode"]) if "mode" in data.files else "sync"
    if mode != "sync":
        np.savez(out, **{"train": run_train, "serve": run_serve}[mode](data))
        return
    mesh = jax.make_mesh((WORLD,), ("data",))
    res = {}
    for name, (fields, elastic) in json.loads(str(data["cases"])).items():
        fields = dict(fields, sparsity=float(data["sparsity"]),
                      mu=float(data["mu"]))
        grads = data[f"grads_{name}" if f"grads_{name}" in data.files
                     else "grads"]
        for key, val in run_case(mesh, fields, elastic, grads,
                                 data["parts"]).items():
            res[f"{name}_{key}"] = val
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[2], sys.argv[3])
