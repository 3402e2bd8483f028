"""Serving steps: prefill and batched greedy decode (the port of
``repro.serve.step``'s ``serve_parallel``, ``decode_cache_specs``,
``build_prefill`` and ``build_decode_step``).

Each builder returns a plain function: ``prefill(params, batch) ->
(logits (B, V), cache)`` with a cache of ``run.shape.seq_len`` positions
(a sliding model: min(window, seq_len) slots), and ``decode(params,
cache, token (B, 1)) -> (logits (B, V), cache)``, which writes the cache
in place. Both run under ``torch.inference_mode``. The model is
``resolve_model_cfg(run)``: ``attn_override="sliding"`` serves a dense
model's sliding variant.

Over a process group of n ranks (``group``; None: one rank, or the
default group when one is initialised), as the reference shards a mesh's
data axes:

- a data-parallel batch: both functions take the global batch (or
  token), rank r prefills and decodes its rows [r B/n, (r + 1) B/n) with
  a cache of those rows, and the logits are all-gathered to (B, V) in
  rank order (the reference's ``out_specs=P(dpaxes, None)``);
- context-parallel decode, when the global batch is below n (the
  reference's ``cache_seq_axis``): the batch stays whole, each rank
  holds its slice of every attention layer's slots (MLA's ckv and krope
  too) and the whole of every recurrent state (Mamba's, the mLSTM's and
  the sLSTM's, replicated over the data ranks as the reference's
  ``decode_cache_specs`` holds them: every rank steps the whole batch's
  state), and every rank returns the same (B, V) logits. Its cache
  comes from a one-rank prefill through :func:`shard_decode_cache`, as
  the reference's device_put of a one-device cache onto the mesh;
  prefill raises, since its batch does not split.

Under tensor parallelism (``model_group``, a model group of tp ranks
beside each data rank, as ``launch.mesh.make_group`` numbers them) each
rank holds its share of the parameters and its key/value heads of the
cache (its share of each recurrent state; MLA's whole ckv and krope; an
encoder-decoder's ``cross`` k and v), the sequence is never split, the
encoder and the patches take the whole stub inputs on every rank, and
both functions return the padded vocabulary's logits (B, V padded to a
multiple of tp), gathered over the model group, then over the data
group's rows. Ring attention is the train step's alone: serving splits
attention by heads (the reference's ``serve_parallel``).

A batch (or cache) that n does not split raises ValueError. The model
may be of any family; an MoE layer's capacity follows the tokens a rank
routes, as the reference's does under its shard_map (under
context-parallel decode every rank routes the whole batch: one device's
capacity); under a data-parallel batch a recurrent layer's state is cut
by rows like attention's k and v; a
vision or audio model's batch carries its patches or frames, cut by rows
with the tokens, and an encoder-decoder's ``cross`` cache leaf is cut by
rows under a data-parallel batch and held whole on every rank under
context-parallel decode (the encoder's sequence is never sharded).
"""
from __future__ import annotations

import torch

from repro_torch.backend import configure_numerics, resolve_device
from repro_torch.configs.base import RunConfig, resolve_model_cfg
from repro_torch.core.flatten import tree_from_items, tree_items
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.parallel import Parallel, all_gather_rows, world


def serve_parallel(run: RunConfig, group=None, *, decode: bool,
                   model_group=None) -> Parallel:
    """The serving step's ``Parallel`` over the data ``group`` and the
    ``model_group``: the cache's sequence axis sharded (context-parallel
    decode) when ``decode`` and the global batch is below the data
    group's size. The sequence is never split over the model group."""
    n, _ = world(group)
    return Parallel(group=group,
                    cache_seq_sharded=decode and run.shape.global_batch < n,
                    model_group=model_group)


def decode_cache_layout(run: RunConfig, n: int, cache_seq_sharded: bool):
    """(rows, slots) of one rank's decode cache among ``n`` ranks (the
    counterpart of ``decode_cache_specs``): the global batch's rows and a
    slice of the attention layers' slots under context-parallel decode
    (a recurrent state then the global batch's, whole), else a share of
    the rows and every slot. An encoder-decoder's ``cross`` leaf has the
    same rows and every encoder position either way. ValueError where n
    does not split them."""
    cfg = resolve_model_cfg(run)
    b = run.shape.global_batch
    slots = attn.cache_max_seq(cfg, run.shape.seq_len)
    if cache_seq_sharded:
        return b, tfm.cache_slice_len(slots, n)
    if b % n:
        raise ValueError(f"a batch of {b} rows does not split over {n} "
                         "data-parallel ranks")
    return b // n, slots


def shard_decode_cache(cache: dict, run: RunConfig, group=None,
                       model_group=None) -> dict:
    """This rank's part of a one-rank decode cache of the global batch
    (``tfm.prefill``'s) under :func:`serve_parallel`'s layout for decode:
    under tensor parallelism first its key/value heads and its share of
    each recurrent state (``convert.split_cache``; MLA's ckv and krope
    whole), then under context-parallel decode its slice of the slots of
    the attention leaves (``attn.CACHE_KEYS``) and the other leaves
    whole (the recurrent states and the ``cross`` k and v, cloned), or
    under a data-parallel batch its rows of every leaf; the step counter
    as it is. The stacked ``blocks`` leaves hold the rows on dim 1 and an
    attention layer's slots on dim 2, the ``prefix`` layers' a dim
    before; a recurrent layer's state has rows only; the stacked
    ``cross`` k and v hold the rows on dim 1."""
    if model_group is not None:
        from repro_torch.convert import split_cache
        tp, m = world(model_group)
        cache = split_cache(cache, tp, m)
    n, r = world(group)
    pal = serve_parallel(run, group, decode=True)
    rows, slots = decode_cache_layout(run, n, pal.cache_seq_sharded)
    cfg = resolve_model_cfg(run)
    want = (run.shape.global_batch,
            attn.cache_max_seq(cfg, run.shape.seq_len))
    for path, leaf in tree_items(cache["blocks"]):
        have = tuple(leaf.shape[1:3]) if path[-1] in attn.CACHE_KEYS \
            else (leaf.shape[1], want[1])
        if have != want:
            raise ValueError(f"a cache of (rows, slots) {have} at {path}, "
                             f"but the run serves {want}")

    def cut(path, val):
        lead = int(path[0] in ("blocks", "cross"))
        if not pal.cache_seq_sharded:
            return val.narrow(lead, r * rows, rows).contiguous()
        if path[0] != "cross" and path[-1] in attn.CACHE_KEYS:
            return val.narrow(lead + 1, r * slots, slots).contiguous()
        return val.clone()
    return tree_from_items(
        (path, leaf.clone() if path == ("pos",) else cut(path, leaf))
        for path, leaf in tree_items(cache))


def _build(run: RunConfig, device):
    resolve_device(device)
    configure_numerics()
    cfg = resolve_model_cfg(run)
    tfm.check_model(cfg)
    return cfg


def _rows(x: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Rank r's rows of a global batch."""
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                         f"over {n} data-parallel ranks")
    rows = x.shape[0] // n
    return x[r * rows:(r + 1) * rows]


def build_prefill(run: RunConfig, device=None, *, group=None,
                  model_group=None):
    """``fn(params, batch) -> (logits (B, V), cache)``; batch =
    {"tokens": (B, S)[, "patches" | "frames": (B, P | S_enc, d)]}, the
    global batch; params this rank's; the cache holds this rank's rows
    (and key/value heads)."""
    cfg = _build(run, device)
    n, r = world(group)
    decode_cache_layout(run, n, False)
    pal = serve_parallel(run, group, decode=False, model_group=model_group)

    def fn(params: dict, batch: dict):
        with torch.inference_mode():
            logits, cache = tfm.prefill(
                params, {key: _rows(val, n, r) for key, val in batch.items()},
                cfg, max_seq=run.shape.seq_len, pal=pal)
            return all_gather_rows(logits, group), cache
    return fn


def build_decode_step(run: RunConfig, device=None, *, group=None,
                      model_group=None):
    """``fn(params, cache, token) -> (logits (B, V), cache)``: token (B,
    1) of the global batch; the cache (this rank's rows or slots, and
    key/value heads) is updated in place."""
    cfg = _build(run, device)
    n, r = world(group)
    pal = serve_parallel(run, group, decode=True, model_group=model_group)
    decode_cache_layout(run, n, pal.cache_seq_sharded)

    def fn(params: dict, cache: dict, token: torch.Tensor):
        with torch.inference_mode():
            if pal.cache_seq_sharded:
                return tfm.decode_step(params, cache, token, cfg, pal)
            logits, cache = tfm.decode_step(params, cache,
                                            _rows(token, n, r), cfg, pal)
            return all_gather_rows(logits, group), cache
    return fn


def delta_applier_from_snapshot(run: RunConfig, snap_dir: str, device=None,
                                step=None, *, group=None, model_group=None):
    """A replica's entry to the delta broadcast (the reference's
    ``delta_applier_from_snapshot(run, mesh, pal, snap_dir)``): the
    snapshot under ``snap_dir`` at ``step`` (default: the latest, as grid
    rank 0 finds it) restored as the serving params (templates on the
    ``meta`` device, so nothing else is allocated) and a
    ``DeltaApplier`` at its ``param_version``, whose floor starts there.
    Over a data ``group`` every rank holds the whole tree; over a
    ``model_group`` the snapshot is the joined tree and each rank keeps
    its share (``convert.split_params``' padded layout), read a leaf at a
    time. Returns ``(applier, params)``."""
    from repro_torch.models import init_params
    from repro_torch.serve.delta import (DeltaApplier, grid_groups,
                                         latest_snapshot, read_snapshot)
    dev = resolve_device(device)
    cfg = resolve_model_cfg(run)
    tmpl = init_params(cfg, torch.Generator(), torch.device("meta"),
                       serve_parallel(run, group, decode=False,
                                      model_group=model_group))
    if step is None:
        step = latest_snapshot(snap_dir, grid_groups(group, model_group))
    params, version = read_snapshot(snap_dir, tmpl, step, device=dev,
                                    model_group=model_group)
    return DeltaApplier(params, version=version, group=group,
                        model_group=model_group, cfg=cfg), params
