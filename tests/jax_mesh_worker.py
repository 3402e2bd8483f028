"""The reference's per-step GradientSync on a mesh of N host CPU devices
(driven by tests/test_torch_baselines_gloo.py and
tests/test_torch_bucketed.py, which hold the port's gloo ranks against
it).

    python tests/jax_mesh_worker.py WORLD IN.npz OUT.npz

For each case the inputs list (JSON, as tests/torch_gloo_worker.py's
mode "baselines" reads it) it runs
the per-step sync under ``shard_map`` over WORLD devices, each device one
rank with its own gradient, state and participation bit, and writes g_agg
and n_active of every step and every rank's final state. The device
count is set before jax is imported, so this runs in a process of its
own.
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


def main(inp: str, out: str) -> None:
    data = np.load(inp)
    mesh = jax.make_mesh((WORLD,), ("data",))
    res = {}
    for name, (fields, elastic) in json.loads(str(data["cases"])).items():
        fields = dict(fields, sparsity=float(data["sparsity"]),
                      mu=float(data["mu"]))
        for key, val in run_case(mesh, fields, elastic, data["grads"],
                                 data["parts"]).items():
            res[f"{name}_{key}"] = val
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[2], sys.argv[3])
