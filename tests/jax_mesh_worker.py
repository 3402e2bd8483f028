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
  tokens: the logits of the prefill and of every decode step;
- "collectives": the model axis' collectives (``psum``, ``all_gather``,
  ``psum_scatter``, the MoE's ``all_to_all``, the stop-gradient
  ``pmax``, and ``ppermute`` by +1 and -1 where the inputs carry their
  cotangents) on a ("model",) mesh: each rank's output and ``jax.vjp``
  gradient;
- "tp_train": ``build_train_step`` on ("data", "model") meshes of the
  inputs' reduced models (``arch``, optional head counts and
  vocabulary, ``attn_dist``; a vision model's batch takes the inputs'
  ``patches``, an audio model's their ``frames``): the global initial
  parameters by path, the metrics and ``idx_prev`` of every step, the
  final parameters and every device's copy of the replicated leaves; a
  case with ``ckpt`` also saves ``save_checkpoint`` of the state after
  step 0 there, and publishes a delta of ``delta_k`` entries of the
  global parameters after every step (``DeltaPublisher``): each
  payload, and the global parameters before and after every step by
  path;
- "tp_serve": the mesh's ``build_prefill`` and ``build_decode_step``
  under tensor parallelism: the parameters and the prefill's cache by
  path (the global cache, and each device's own shard of it), the
  logits of the prefill and of every decode step;
- "ring_equal": for each case, one device's parameters (by path) and
  loss, and the loss of ring attention (``build_parallel(mesh,
  attn_dist="ring")``) on the case's mesh with every model rank's
  attention weights set to that one device's;
- "tp": those of the three above that the inputs ask for, in one
  process;
- "cp": context-parallel decode of the inputs' reduced models (JSON
  ``models``: arch, ``absorb``) from one device's parameters (key 0, by
  path): for each case (JSON: model, mesh, batch, prompt and cache
  lengths) the one-device ``prefill`` and ``decode_step`` fed the
  inputs' decode tokens, and ``build_decode_step`` on the case's
  ("data", "model") mesh with the one-device prefill's cache put there
  by ``decode_cache_specs``: every step's logits; where the reference
  cannot place the cache, the error instead of the mesh's logits;
- "delta": for each stream (JSON: the npz of a joined tree, k, the
  versions, the snapshot versions, the version whose payload is
  bit-flipped, the channel schedule), a seeded walk of the tree
  published by ``DeltaPublisher`` into a spool (snapshots at the
  snapshot versions), then the one-rank ``DeltaApplier`` from the
  version-0 snapshot taking one spool file a tick through
  ``FaultyChannel(SpoolChannel)``, resyncing after a gap as
  ``launch.serve`` does: every verdict, the counters and the tree
  after every tick.

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


def _leaves(prefix: str, tree) -> dict:
    """A tree's leaves keyed ``prefix/path``, as numpy."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join([prefix] + keys)] = np.asarray(leaf)
    return out


COLLECTIVES = ("psum", "all_gather", "psum_scatter", "all_to_all", "pmax",
               "ppermute", "ppermute_back")


def run_collectives(data) -> dict:
    """Each model-axis collective of ``repro.models.parallel`` (and the
    MoE's tiled all_to_all, the stop-gradient pmax of the sharded
    cross-entropy, and ring attention's ppermute by +1 and -1) under
    ``shard_map(check_vma=False)`` on a ("model",) mesh of WORLD devices:
    the output of each rank's x and ``jax.vjp``'s gradient of each rank's
    cotangent, for each collective whose cotangents the inputs hold."""
    from repro.models import parallel as par
    mesh = jax.make_mesh((WORLD,), ("model",))
    pal = par.Parallel(model_axis="model", tp=WORLD)
    fns = {"psum": lambda x: par.psum_model(x, pal),
           "all_gather": lambda x: par.all_gather_model(x, pal, axis=1),
           "psum_scatter": lambda x: par.psum_scatter_model(x, pal, axis=1),
           "all_to_all": lambda x: jax.lax.all_to_all(
               x, "model", split_axis=0, concat_axis=1, tiled=True),
           "pmax": lambda x: x * jax.lax.pmax(jax.lax.stop_gradient(x),
                                              "model"),
           "ppermute": lambda x: par.ppermute_model(x, pal, 1),
           "ppermute_back": lambda x: par.ppermute_model(x, pal, -1)}
    res = {}
    for name in COLLECTIVES:
        if f"ct_{name}" not in data:
            continue
        def f(x, ct, fn=fns[name]):
            y, vjp = jax.vjp(fn, x[0])
            return y[None], vjp(ct[0])[0][None]
        fn = jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("model"), P("model")),
            out_specs=(P("model"), P("model")), check_vma=False))
        y, gx = fn(jnp.asarray(data["x"]), jnp.asarray(data[f"ct_{name}"]))
        res[f"{name}_y"], res[f"{name}_gx"] = np.asarray(y), np.asarray(gx)
    return res


def _tp_model(case: dict):
    """A case's reduced model: ``arch`` with ``heads`` (query, key/value)
    and ``vocab`` replaced where given, MLA absorbed with ``absorb``, and
    with ``mla`` MLA attention at DeepSeek-V2-Lite's reduced widths (an
    MLA encoder-decoder from Whisper's)."""
    import dataclasses

    from repro.configs import base
    cfg = base.reduced_config(base.get_config(case["arch"]))
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


def _shards(prefix: str, tree, mesh) -> dict:
    """Every device's own shard of each leaf, keyed ``prefix{i}/path``
    with i the device's place in the mesh (model-minor): what that rank
    computed, whatever the global layout its out_specs give."""
    order = {dev.id: i for i, dev in enumerate(mesh.devices.flat)}
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        for sh in leaf.addressable_shards:
            out["/".join([f"{prefix}{order[sh.device.id]}"] + keys)] = \
                np.asarray(sh.data)
    return out


def _stub_batch(cfg, data, rows=None) -> dict:
    """The inputs' stub array of the model's frontend: {"patches": ...}
    for a vision model, {"frames": ...} for an audio model, else {}
    (its first ``rows`` rows when given)."""
    key = {"vision_stub": "patches", "audio_stub": "frames"}.get(
        cfg.frontend)
    if key is None:
        return {}
    return {key: jnp.asarray(data[key][:rows])}


def run_tp_train(data) -> dict:
    """For each case (JSON: arch, mesh, sparsifier, optional heads,
    vocab, ``attn_dist``, ``ckpt`` and ``delta_k``), ``build_train_step``
    on that ("data", "model") mesh over the global batch: the global
    (mesh-assembled) initial parameters by path, every step's metrics,
    the final global parameters (flat) and the (DP, TP, k) ``idx_prev``;
    with ``ckpt`` the checkpoint after step 0 and every step's delta
    payload and global parameters."""
    from repro.checkpoint import save_checkpoint
    from repro.configs import base
    from repro.serve.delta import DeltaPublisher
    from repro.train.step import (build_parallel, build_train_step,
                                  init_train_state)
    steps = int(data["steps"])
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        run = base.RunConfig(
            model=_tp_model(case), shape=base.SHAPES["train_4k"],
            sparsifier=base.SparsifierConfig(**case["sparsifier"]),
            optimizer=base.OptimizerConfig(kind="adam", lr=1e-3,
                                           **case.get("optimizer", {})),
            seed=0, steps=steps)
        batch = {"tokens": jnp.asarray(data["tokens"]),
                 "targets": jnp.asarray(data["targets"]),
                 **_stub_batch(run.model, data)}
        mesh = _mesh(tuple(case["mesh"]))
        pal = build_parallel(mesh, attn_dist=case.get("attn_dist", "sp"))
        ckpt = case.get("ckpt")
        with mesh:
            params, opt, ef = init_train_state(run, mesh, pal,
                                               jax.random.PRNGKey(0))
            res.update(_leaves(f"{name}_init", jax.device_get(params)))
            pub = DeltaPublisher(params, case["delta_k"]) if ckpt else None
            step, _, _ = build_train_step(run, mesh, pal)
            jstep = jax.jit(step)
            for t in range(steps):
                params, opt, ef, m = jstep(params, opt, ef, batch,
                                           jax.random.PRNGKey(0))
                for key, val in m.items():
                    res[f"{name}_{key}_{t}"] = np.asarray(val)
                res[f"{name}_idx_prev_{t}"] = np.asarray(ef["idx_prev"])
                if pub is not None:
                    res.update(_leaves(f"{name}_step{t}",
                                       jax.device_get(params)))
                    pay = pub.publish(params)
                    for key in ("values", "indices", "checksum"):
                        res[f"{name}_delta{pay.version}_{key}"] = \
                            np.asarray(getattr(pay, key))
                if ckpt and t == 0:
                    save_checkpoint(ckpt, 1, params, opt, ef,
                                    param_version=pub.version)
            res[f"{name}_params"] = _flat(jax.device_get(params))
            res[f"{name}_idx_prev"] = np.asarray(ef["idx_prev"])
            res[f"{name}_replicated"] = _replicated_by_device(params, mesh)
    return res


def _replicated_by_device(params, mesh) -> np.ndarray:
    """(devices, n): every device's own copy of the leaves replicated
    over the model axis (those whose shard is the whole leaf), flat in
    leaf order, the devices in mesh order (model-minor). Under a
    sparsified sync the copies may differ: each rank selects its
    entries of them on its own threshold."""
    order = {dev.id: i for i, dev in enumerate(mesh.devices.flat)}
    rows = [[] for _ in order]
    for leaf in jax.tree_util.tree_leaves(params):
        shards = leaf.addressable_shards
        if shards[0].data.shape != leaf.shape:
            continue
        for sh in shards:
            rows[order[sh.device.id]].append(np.asarray(sh.data).ravel())
    return np.stack([np.concatenate(r) for r in rows])


def run_tp_serve(data) -> dict:
    """For each case (JSON: arch, attn, mesh, batch, prompt, seq),
    parameters drawn as the train step draws them on that mesh (global,
    by path), then the mesh's ``build_prefill`` and ``build_decode_step``
    fed the inputs' tokens (teacher forcing) and the model's stub inputs
    (the inputs' ``serve_patches`` or ``serve_frames``): the prefill's
    logits and global cache (by path) and every decode step's logits."""
    from repro.configs import base
    from repro.serve.step import (build_decode_step, build_prefill,
                                  serve_parallel)
    from repro.train.step import build_parallel, init_train_state
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        cfg = _tp_model(dict(case, window=data["window"]))
        b, prompt, seq = case["batch"], case["prompt"], case["seq"]
        mesh = _mesh(tuple(case["mesh"]))
        run = base.RunConfig(
            model=cfg, shape=base.ShapeConfig("serve", seq, b, "decode"),
            sparsifier=base.SparsifierConfig(kind="none"))
        tokens = jnp.asarray(data["tokens"][:b, :prompt])
        feed = data["tokens"][:b, prompt:]
        with mesh:
            params = init_train_state(run, mesh, build_parallel(mesh),
                                      jax.random.PRNGKey(0))[0]
            res.update(_leaves(f"{name}_init", jax.device_get(params)))
            pre, _ = build_prefill(run, mesh, serve_parallel(
                mesh, run, decode=False))
            stubs = _stub_batch(cfg, {key[6:]: val for key, val in
                                      data.items()
                                      if key.startswith("serve_")}, b)
            lg, cache = jax.jit(pre)(params, {"tokens": tokens, **stubs})
            res[f"{name}_prefill"] = np.asarray(lg)
            res.update(_leaves(f"{name}_cache", jax.device_get(cache)))
            res.update(_shards(f"{name}_shard", cache, mesh))
            dec, _ = build_decode_step(run, mesh, serve_parallel(
                mesh, run, decode=True))
            dec = jax.jit(dec)
            for t in range(feed.shape[1]):
                lg, cache = dec(params, cache, jnp.asarray(feed[:, t:t + 1]))
                res[f"{name}_decode_{t}"] = np.asarray(lg)
    return res


def _tiled_attention(tree, tp: int):
    """A one-device parameter tree in the global layout of ring attention
    on a model axis of tp with every model rank's attention weights (the
    split leaves of ``attn`` and ``cross``) that one device's: each such
    leaf repeated tp times along its split dimension."""
    from repro.models.specs import param_specs
    specs = jax.tree_util.tree_leaves(
        param_specs(tree), is_leaf=lambda x: isinstance(x, P))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for (path, leaf), spec in zip(leaves, specs):
        keys = [k.key for k in path if hasattr(k, "key")]
        dim = next((i for i, a in enumerate(spec) if a == "model"), None)
        if dim is not None and keys[-2] in ("attn", "cross"):
            leaf = jnp.concatenate([leaf] * tp, dim)
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


def ring_model(case: dict):
    """A ring_equal case's reduced model; an MoE model at capacity factor
    16 (no choice dropped) without the load-balance term, which depend
    on which rank routes which token."""
    import dataclasses
    cfg = _tp_model(case)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0, load_balance_loss=0.0))
    return cfg


def run_ring_equal(data) -> dict:
    """For each case (JSON: arch, mesh (1, tp), optional attn and
    window): one device's initial parameters (key 0, by path) and its
    jitted loss on the inputs' batch, and the loss of ring attention on
    the mesh (the model group's sum of the shares) with every model rank
    holding that device's attention weights (``_tiled_attention``)."""
    from repro.models import init_params, loss_fn
    from repro.models.parallel import Parallel
    from repro.models.specs import param_specs
    from repro.models.transformer import global_loss
    from repro.train.step import build_parallel
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "targets": jnp.asarray(data["targets"])}
    res = {}
    for name, case in json.loads(str(data["cases"])).items():
        cfg = ring_model(dict(case, window=case.get("window", 0)))
        one = init_params(cfg, Parallel(), jax.random.PRNGKey(0))
        res.update(_leaves(f"{name}_one", jax.device_get(one)))
        res[f"{name}_one_loss"] = np.asarray(jax.jit(
            lambda p: loss_fn(p, batch, cfg, Parallel())[0])(one))
        mesh = _mesh(tuple(case["mesh"]))
        pal = build_parallel(mesh, attn_dist="ring")
        glob = _tiled_attention(one, pal.tp)
        bspec = {key: P(pal.data_axes, None) for key in batch}

        def f(p, b):
            return global_loss(loss_fn(p, b, cfg, pal)[0], pal)
        fn = jax.jit(jax.shard_map(f, mesh=mesh,
                                   in_specs=(param_specs(glob), bspec),
                                   out_specs=P(), check_vma=False))
        with mesh:
            res[f"{name}_ring_loss"] = np.asarray(fn(glob, batch))
    return res


def run_tp(data) -> dict:
    """In one process, those of the modes "collectives" (when the inputs
    hold ``x``), "tp_train" (``train_cases``), "ring_equal"
    (``ring_cases``) and "tp_serve" (``serve_cases`` on ``serve_tokens``)
    that the inputs ask for."""
    res = run_collectives(data) if "x" in data else {}
    if "train_cases" in data:
        res.update(run_tp_train(dict(data, cases=data["train_cases"])))
    if "ring_cases" in data:
        res.update(run_ring_equal(dict(data, cases=data["ring_cases"])))
    if "serve_cases" in data:
        res.update(run_tp_serve(dict(data, cases=data["serve_cases"],
                                     tokens=data["serve_tokens"])))
    return res


def run_cp(data) -> dict:
    """Context-parallel decode of the inputs' models (module docstring,
    mode "cp")."""
    from jax.sharding import NamedSharding

    from repro.configs import base
    from repro.models import decode_step, init_params, prefill
    from repro.models.parallel import Parallel
    from repro.serve.step import (build_decode_step, decode_cache_specs,
                                  serve_parallel)
    models = json.loads(str(data["models"]))
    one = Parallel()
    res, params = {}, {}
    for mname, spec in models.items():
        cfg = _tp_model(spec)
        params[mname] = (cfg, init_params(cfg, one, jax.random.PRNGKey(0)))
        res.update(_leaves(f"{mname}_init", jax.device_get(
            params[mname][1])))
    for name, case in json.loads(str(data["cases"])).items():
        cfg, p = params[case["model"]]
        b, prompt, seq = case["batch"], case["prompt"], case["seq"]
        run = base.RunConfig(
            model=cfg, shape=base.ShapeConfig("serve", seq, b, "decode"),
            sparsifier=base.SparsifierConfig(kind="none"))
        tokens = jnp.asarray(data["tokens"][:b, :prompt])
        feed = data["tokens"][:b, prompt:]
        _, cache = jax.jit(lambda q, t: prefill(
            q, {"tokens": t}, cfg, one, max_seq=seq))(p, tokens)
        dec1 = jax.jit(lambda q, c, t: decode_step(q, c, t, cfg, one))
        c1 = cache
        for t in range(feed.shape[1]):
            lg, c1 = dec1(p, c1, jnp.asarray(feed[:, t:t + 1]))
            res[f"{name}_one_decode_{t}"] = np.asarray(lg)
        mesh = _mesh(tuple(case["mesh"]))
        pal = serve_parallel(mesh, run, decode=True)
        assert pal.cache_seq_axis is not None, name
        with mesh:
            try:
                _, cspecs, _, _ = decode_cache_specs(run, mesh, pal)
                mcache = jax.device_put(cache, jax.tree_util.tree_map(
                    lambda sp: NamedSharding(mesh, sp), cspecs))
            except ValueError as err:
                res[f"{name}_mesh_error"] = np.asarray(str(err))
                continue
            dec, _ = build_decode_step(run, mesh, pal)
            dec = jax.jit(dec)
            for t in range(feed.shape[1]):
                lg, mcache = dec(p, mcache, jnp.asarray(feed[:, t:t + 1]))
                res[f"{name}_mesh_decode_{t}"] = np.asarray(lg)
    return res


def _tree_of(npz) -> dict:
    """A nested dict of jax arrays from ``a/b/c`` keys."""
    tree = {}
    for key in npz.files:
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(npz[key])
    return tree


def _walk(tree, rng, moves: int, real) -> dict:
    """The tree with ``moves`` seeded entries of its real part (``real``,
    by key: a flat bool mask) moved by a standard normal step."""
    flat = {key: np.array(val) for key, val in _flat_items(tree)}
    keys = sorted(flat)
    sizes = np.array([flat[key].size for key in keys])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    mask = np.concatenate([real[key].ravel() for key in keys])
    live = np.flatnonzero(mask)
    picks = rng.choice(live, moves, replace=False)
    step = rng.standard_normal(moves).astype(np.float32)
    for pos, dv in zip(picks, step):
        i = int(np.searchsorted(offsets, pos, side="right")) - 1
        flat[keys[i]].reshape(-1)[pos - offsets[i]] += dv
    return _unflat(flat)


def _flat_items(tree, prefix=()):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _flat_items(val, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), val


def _unflat(flat: dict) -> dict:
    tree = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(val)
    return tree


def run_delta(data) -> dict:
    """The one-rank applier's run of each stream (module docstring,
    mode "delta")."""
    import dataclasses
    import shutil

    from repro.core.faults import parse_channel_schedule
    from repro.serve.delta import (DeltaApplier, DeltaPublisher,
                                   FaultyChannel, SpoolChannel, read_snapshot,
                                   write_snapshot)
    res = {}
    for name, st in json.loads(str(data["streams"])).items():
        root = st["root"]
        with np.load(st["tree"]) as npz:
            tree = _tree_of(npz)
        with np.load(st["real"]) as npz:
            real = {key: npz[key] for key in npz.files}
        rng = np.random.default_rng(st["seed"])
        pub = DeltaPublisher(tree, st["k"])
        src, snaps = os.path.join(root, "source"), os.path.join(root,
                                                                 "snapshots")
        write_snapshot(snaps, tree, 0)
        sender = SpoolChannel(src)
        cur = tree
        for v in range(1, st["versions"] + 1):
            cur = _walk(cur, rng, st["moves"], real)
            pay = pub.publish(cur)
            if v == st["flip"]:
                vals = np.array(pay.values, np.float32)
                vals.view(np.uint32)[0] ^= np.uint32(1 << 9)
                pay = dataclasses.replace(pay, values=vals)
            sender.send(pay)
            if v in st["snapshots"]:
                write_snapshot(snaps, pub.published, v)
        files = sorted(f for f in os.listdir(src) if f.endswith(".npz"))
        live = os.path.join(root, "oracle_spool")
        chan = FaultyChannel(SpoolChannel(live),
                             parse_channel_schedule(st["schedule"]))
        start, version = read_snapshot(snaps, tree, 0)
        app = DeltaApplier(jax.tree_util.tree_map(jnp.asarray, start),
                           version=version)
        verdicts = []

        def intake(payloads):
            for p in payloads:
                verdicts.append(app.offer(p))
            if app.needs_resync and app.can_resync(snaps):
                app.resync_from(snaps)
        for t, fname in enumerate(files):
            shutil.copy(os.path.join(src, fname), os.path.join(live, fname))
            intake(chan.recv())
            res.update({f"{name}_tick{t}/{key}": np.asarray(val)
                        for key, val in _flat_items(app.params)})
            res[f"{name}_version_{t}"] = np.asarray(app.version)
        intake(chan.flush())
        res.update({f"{name}_final/{key}": np.asarray(val)
                    for key, val in _flat_items(app.params)})
        res[f"{name}_verdicts"] = np.asarray(verdicts)
        res[f"{name}_metrics"] = np.asarray(json.dumps(
            {key: int(val) if not isinstance(val, bool) else val
             for key, val in app.metrics().items()}))
        res.update({f"{name}_published/{key}": np.asarray(val)
                    for key, val in _flat_items(pub.published)})
    return res


def main(inp: str, out: str) -> None:
    data = np.load(inp)
    mode = str(data["mode"]) if "mode" in data.files else "sync"
    if mode != "sync":
        np.savez(out, **{"train": run_train, "serve": run_serve,
                         "collectives": run_collectives,
                         "tp_train": run_tp_train,
                         "tp_serve": run_tp_serve,
                         "ring_equal": run_ring_equal,
                         "tp": run_tp, "cp": run_cp,
                         "delta": run_delta}[mode](data))
        return
    mesh = jax.make_mesh((WORLD,), ("data",))
    if "auto_buckets" in data.files:
        # the bucket auto-tune at the hardware and launch floor the test
        # sets (the default is bound when auto_num_buckets is defined)
        import functools

        from repro.roofline import analysis
        *hw, latency = json.loads(str(data["auto_buckets"]))
        analysis.auto_num_buckets = functools.partial(
            analysis.auto_num_buckets, hw=analysis.Hardware(*hw),
            latency_s=latency)
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
