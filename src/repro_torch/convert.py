"""Carry weights and state between the reference and the port.

The reference's trees arrive as numpy trees (``jax.device_get`` output);
the port's are nested dicts (and lists: a dense ``prefix``) of tensors in
the same layout, so parameters (every mixer's: attention, Mamba, mLSTM,
sLSTM; an encoder-decoder's ``encoder`` subtree and its decoder layers'
``cross`` and ``norm_x``), decode caches (an encoder-decoder's top-level
``cross`` k and v among them) and fp32 state move as they are. Three
translations: the index dtype (the reference's uint32 indices become the
port's int32 view of the same bits, ``core.bigvec``, and back), bf16
state and caches (``ef_dtype="bfloat16"``, a bf16 model's k and v: the
bits cross as uint16, numpy having no bf16 of its own), and the CNN's
convolution weights, HWIO in the reference and OIHW in the port
(``models.cnn``).

Under tensor parallelism a rank holds its share of each parameter and
of the decode cache: :func:`split_params` cuts a global tree (the
reference's, as its mesh assembles it) into rank r's by the port's
``models.specs``, :func:`join_params` gathers the ranks' trees back,
and :func:`split_cache` and :func:`join_cache` do the same for a decode
cache by :func:`cache_split_dims` (attention's key/value heads, Mamba's
and the sLSTM's channels, the mLSTM's value dims; MLA's ckv and krope
and the mLSTM's n and m whole).

The CNN's flat J-vector (:func:`ravel_cnn`, :func:`unravel_cnn`) is in
the order of the reference's ``jax.flatten_util.ravel_pytree`` over its
parameter dict: sorted keys, each leaf flattened C-order in its HWIO
layout. So index i names the same weight in both packages, and
selection, tie order, the posterior and the sketch's hashes agree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flatten import tree_from_items, tree_items, tree_map


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """A bf16 CPU tensor from its uint16 bit patterns (numpy has no bf16
    of its own: the bits cross as uint16)."""
    return torch.from_numpy(np.array(bits.view(np.uint16)).view(
        np.int16)).view(torch.bfloat16)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """The uint16 bit patterns of a bf16 tensor, on the host."""
    return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype.name == "bfloat16":
        return bf16_from_bits(a).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor, uint_keys=False) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # the bits as uint16, viewed as the reference's bf16 numpy dtype
        # (``ml_dtypes``, which jax brings) where it is installed
        a = bf16_bits(t)
        try:
            import ml_dtypes
        except ImportError:
            return a
        return a.view(ml_dtypes.bfloat16)
    a = t.numpy()
    return a.view(np.uint32) if uint_keys else a


def params_from_jax(tree, device="cpu") -> dict:
    """Reference parameter tree (numpy leaves) -> port tree of tensors."""
    return tree_map(lambda x: _to_tensor(x, device).float(), tree)


def params_to_jax(params: dict) -> dict:
    """Port parameter tree -> numpy tree in the reference's layout."""
    return tree_map(_to_numpy, params)


def cache_from_jax(cache, device="cpu") -> dict:
    """The reference's decode cache ``{pos, blocks/l{j}/{k, v} | {ckv,
    krope} | {conv, h} | {c, n, m}[, prefix/[i]/...][, cross/{k, v}]}``
    (numpy leaves: attention's, Mamba's and the xLSTM mixers' state, an
    encoder-decoder's cross k and v) -> the port's, dtypes kept (a bf16
    cache bit for bit, a recurrent state's fp32)."""
    return tree_map(lambda x: _to_tensor(x, device), cache)


def cache_to_jax(cache: dict) -> dict:
    """Inverse of :func:`cache_from_jax`."""
    return tree_map(_to_numpy, cache)


def state_from_jax(state: dict, device="cpu") -> dict:
    """Sparsifier or optimizer state (a flat dict of arrays) -> tensors.
    Sparsifier keys: the fused layout's ``err_prev`` or the reference
    layout's ``err``, DGC's momentum ``mom``, REGTOP-k's dense posterior
    ``a_prev``/``s_prev``/``g_agg_prev`` or its O(k) one
    ``idx_prev``/``a_prev_sel``/``g_prev_sel``, and ``step``; optimizer
    keys: ``master``, the moments ``m`` (momentum, adam, adamw) and ``v``
    (adam, adamw), and ``step``. fp32 state moves as it is, bf16 state
    bit for bit; uint32 index arrays become int32 views of the same
    bits."""
    return {key: _to_tensor(val, device) for key, val in state.items()}


def state_to_jax(state: dict) -> dict:
    """Inverse of :func:`state_from_jax`: ``idx_prev`` back to uint32."""
    return {key: _to_numpy(val, uint_keys=key == "idx_prev")
            for key, val in state.items()}


def _is_conv(leaf) -> bool:
    return leaf.ndim == 4


def cnn_params_from_jax(tree, device="cpu") -> dict:
    """The reference's CNN parameters (numpy, HWIO) -> the port's (OIHW)."""
    return {key: _to_tensor(np.transpose(val, (3, 2, 0, 1))
                            if _is_conv(np.asarray(val)) else val,
                            device).float()
            for key, val in tree.items()}


def cnn_params_to_jax(params: dict) -> dict:
    """The port's CNN parameters (OIHW) -> numpy in the reference's HWIO."""
    return {key: _to_numpy(val.permute(2, 3, 1, 0) if _is_conv(val)
                           else val)
            for key, val in params.items()}


def ravel_cnn(params: dict) -> torch.Tensor:
    """The CNN parameters (or their gradients) as one fp32 J-vector in the
    reference's ravel order."""
    return torch.cat([(params[key].permute(2, 3, 1, 0)
                       if _is_conv(params[key]) else params[key]).reshape(-1)
                      for key in sorted(params)])


def unravel_cnn(vec: torch.Tensor, like: dict) -> dict:
    """Inverse of :func:`ravel_cnn`: the J-vector back into parameters of
    ``like``'s shapes (OIHW, contiguous)."""
    out, pos = {}, 0
    for key in sorted(like):
        shape = like[key].shape
        n = like[key].numel()
        leaf = vec[pos:pos + n]
        if len(shape) == 4:
            o, i, kh, kw = shape
            leaf = leaf.reshape(kh, kw, i, o).permute(3, 2, 0, 1)
        out[key] = leaf.reshape(shape).contiguous()
        pos += n
    if pos != vec.numel():
        raise ValueError(f"J-vector of {vec.numel()} for {pos} parameters")
    return out


def split_leaf(path, leaf, tp: int, rank: int):
    """Model rank ``rank``'s share (of ``tp``) of the global parameter
    leaf at ``path``: cut along its split dimension (``models.specs``);
    a replicated leaf whole."""
    from repro_torch.models.specs import leaf_dim
    return _part(leaf, leaf_dim(path, np.ndim(leaf)), tp, rank)


def join_leaf(path, parts: list):
    """The global parameter leaf at ``path`` from every model rank's
    share, in rank order: the inverse of :func:`split_leaf` (a
    replicated leaf rank 0's)."""
    from repro_torch.models.specs import leaf_dim
    return _join(parts, leaf_dim(path, np.ndim(parts[0])))


def split_params(tree, tp: int, rank: int) -> dict:
    """Model rank ``rank``'s local parameter tree (of ``tp``) cut from a
    global one: the reference's mesh-assembled tree (numpy) or the
    port's (tensors), in the padded layout tensor parallelism uses (head
    counts, experts and the vocabulary padded to multiples of tp). Each
    leaf is cut by :func:`split_leaf`."""
    return tree_from_items((path, split_leaf(path, leaf, tp, rank))
                           for path, leaf in tree_items(tree))


def join_params(trees: list) -> dict:
    """The global parameter tree from every model rank's local tree, in
    rank order: the inverse of :func:`split_params`, a leaf at a time
    (:func:`join_leaf`)."""
    per_rank = [tree_items(t) for t in trees]
    return tree_from_items(
        (path, join_leaf(path, [items[i][1] for items in per_rank]))
        for i, (path, _) in enumerate(per_rank[0]))


def cache_split_dims(cache) -> list:
    """[(path, the dimension split over the model group or None)] of a
    decode cache's leaves, in ``tree_items`` order: attention's k and v
    (.., B, S, KV, hd) by key/value head; Mamba's conv (.., B, d_conv -
    1, C) and h (.., B, C, N) by channel; an mLSTM's c (.., B, h, hdv,
    hd) by value dim, its n (.., B, h, hd) and m (.., B, h) whole; an
    sLSTM's c, n and m (.., B, C) by channel (a layer's c with one more
    dimension than its n is an mLSTM's); ``pos``, MLA's ckv and krope
    whole. Context-parallel decode beside a model group then cuts only
    the attention leaves by slots over the data ranks
    (``serve.step.shard_decode_cache``), so MLA's cache is split by slots
    only and a recurrent state by channels only."""
    items = tree_items(cache)
    ndim = {path: np.ndim(leaf) for path, leaf in items}

    def dim(path):
        name, n = path[-1], ndim[path]
        if name in ("k", "v", "h"):
            return n - 2
        if name == "conv":
            return n - 1
        if name in ("c", "n", "m"):
            layer = path[:-1]
            mlstm = ndim[layer + ("c",)] == ndim[layer + ("n",)] + 1
            if not mlstm:
                return n - 1
            return n - 2 if name == "c" else None
        return None
    return [(path, dim(path)) for path, _ in items]


def split_cache(cache, tp: int, rank: int) -> dict:
    """Model rank ``rank``'s part of a global decode cache, each leaf cut
    along its :func:`cache_split_dims` dimension, the others whole."""
    dims = dict(cache_split_dims(cache))
    return tree_from_items(
        (path, _part(leaf, dims[path], tp, rank))
        for path, leaf in tree_items(cache))


def join_cache(caches: list) -> dict:
    """The inverse of :func:`split_cache`: every model rank's cache, in
    rank order."""
    per_rank = [tree_items(c) for c in caches]
    dims = cache_split_dims(caches[0])
    return tree_from_items(
        (path, _join([items[i][1] for items in per_rank], dims[i][1]))
        for i, (path, _) in enumerate(per_rank[0]))


def _part(leaf, dim, tp: int, rank: int):
    if dim is None:
        return leaf
    size = leaf.shape[dim]
    if size % tp:
        raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not split "
                         f"over tp={tp}")
    n = size // tp
    index = [slice(None)] * np.ndim(leaf)
    index[dim] = slice(rank * n, (rank + 1) * n)
    return leaf[tuple(index)]


def _join(parts: list, dim):
    if dim is None:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim)
    return np.concatenate(parts, dim)
