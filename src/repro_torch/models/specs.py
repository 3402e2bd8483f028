"""Which dimension of each parameter leaf is split over the model group
(the port's copy of ``repro.models.specs``).

The rules go by (parent module, leaf name), as the reference's do, and
the port's parameter tree names its leaves as the reference's does, so
they carry over by key. A leaf under ``blocks`` (a stacked super-block
leaf) has a leading stack dimension, so its split dimension is one
further in; a 1-D vector under a stack splits its last dimension. Norms
everywhere, the MoE router, a GELU MLP's ``down_b`` and MLA's
``dkv``/``kv_norm`` are replicated: every model rank holds the same
bits, and their gradients are summed over the model group.

Used by the train step (the replicated leaves' gradient sum, the
gradient-norm weights), by ``convert`` (a global tree cut into rank
r's local tree and gathered back) and by the delta applier over a model
group (``serve.delta``: each leaf's split dimension, and
:func:`real_entries`, the entries of the padded layout that are not
padding).
"""
from __future__ import annotations

from repro_torch.core.flatten import tree_from_items, tree_items

_COL = 1          # output dimension split (column parallel)
_ROW = 0          # input dimension split (row parallel)
_VEC = 0          # a 1-D vector split
_REP = None       # replicated

RULES = {
    # attention (GQA + MLA)
    ("attn", "wq"): _COL, ("attn", "wk"): _COL, ("attn", "wv"): _COL,
    ("attn", "wo"): _ROW,
    ("attn", "bq"): _VEC, ("attn", "bk"): _VEC, ("attn", "bv"): _VEC,
    ("attn", "dkv"): _REP, ("attn", "kv_norm"): _REP,
    ("attn", "uk"): _COL, ("attn", "uv"): _COL,
    ("cross", "wq"): _COL, ("cross", "wk"): _COL, ("cross", "wv"): _COL,
    ("cross", "wo"): _ROW,
    ("cross", "bq"): _VEC, ("cross", "bk"): _VEC, ("cross", "bv"): _VEC,
    # dense MLP
    ("mlp", "gate"): _COL, ("mlp", "up"): _COL, ("mlp", "down"): _ROW,
    ("mlp", "up_b"): _VEC, ("mlp", "down_b"): _REP,
    ("shared", "gate"): _COL, ("shared", "up"): _COL,
    ("shared", "down"): _ROW,
    ("shared", "up_b"): _VEC, ("shared", "down_b"): _REP,
    # MoE (the expert dimension split)
    ("moe", "router"): _REP,
    ("moe", "gate"): 0, ("moe", "up"): 0, ("moe", "down"): 0,
    # mamba (channel parallel)
    ("mamba", "conv_w"): 1, ("mamba", "conv_b"): _VEC,
    ("mamba", "x_proj"): _ROW, ("mamba", "dt_proj"): _COL,
    ("mamba", "dt_bias"): _VEC, ("mamba", "A_log"): 0, ("mamba", "D"): _VEC,
    ("mamba", "out_proj"): _ROW,
    ("mamba", "in_x"): _COL, ("mamba", "in_z"): _COL,
    # mLSTM (the value dimension split on its own axis)
    ("mlstm", "up"): _REP, ("mlstm", "up_gate"): 2,
    ("mlstm", "wq"): _REP, ("mlstm", "wk"): _REP, ("mlstm", "wv"): 2,
    ("mlstm", "wif"): _REP, ("mlstm", "ln_h"): 1, ("mlstm", "down"): 1,
    # sLSTM (split gate projections, column parallel)
    ("slstm", "wi"): _COL, ("slstm", "wf"): _COL, ("slstm", "wz"): _COL,
    ("slstm", "wo"): _COL,
    ("slstm", "ln_h"): _VEC, ("slstm", "down"): _ROW,
    # embedding and head (the vocabulary split)
    ("embed", "tok"): 0, ("embed", "head"): _COL,
}
_NORM_KEYS = {"scale", "bias"}
_NORM_PARENTS = {"norm", "norm1", "norm2", "norm_x", "final_norm",
                 "kv_norm"}


def leaf_dim(path: tuple, ndim: int):
    """The dimension of a leaf at ``path`` (with ``ndim`` dimensions)
    split over the model group, or None when it is replicated. KeyError
    for a leaf no rule covers."""
    keys = [key for key in path if isinstance(key, str)]
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    if parent in _NORM_PARENTS or name in _NORM_KEYS or name == "kv_norm":
        return None
    if (parent, name) not in RULES:
        raise KeyError(f"no sharding rule for param {'/'.join(keys)}")
    dim = RULES[(parent, name)]
    if dim is None:
        return None
    return min(dim + ("blocks" in keys), ndim - 1)


def param_specs(params) -> dict:
    """The tree of split dimensions (None: replicated) of a parameter
    tree."""
    return tree_from_items((path, leaf_dim(path, leaf.ndim))
                           for path, leaf in tree_items(params))


def replicated_mask(params) -> dict:
    """The tree of booleans: True for the leaves replicated over the model
    group (whose gradients are summed over it)."""
    return tree_from_items((path, leaf_dim(path, leaf.ndim) is None)
                           for path, leaf in tree_items(params))


def real_entries(path: tuple, shape: tuple, cfg, tp: int):
    """``(dim, keep)`` for a leaf of ``shape`` in the padded global layout
    of tensor parallelism over ``tp`` ranks (``convert.split_params``'s):
    ``keep`` (shape[dim],) is False at the padding along ``dim`` (query
    heads padded to a multiple of tp in wq, bq, uk, uv and wo; key/value
    heads that no real query head reads; vocabulary rows of the table
    and columns of the head; padded experts' stacks and router columns),
    which is never trained and never written. None for a leaf without
    padding (and for every leaf at tp 1, or under ring attention, which
    pads nothing)."""
    import torch

    from repro_torch.models.parallel import pad_to
    if tp == 1:
        return None
    keys = [key for key in path if isinstance(key, str)]
    name, parent = keys[-1], keys[-2] if len(keys) >= 2 else ""
    lead = int("blocks" in keys)

    def units(dim, n_real, n_pad, width=1, real=None):
        keep = torch.arange(n_pad) < n_real if real is None else real
        keep = keep.repeat_interleave(width)
        if keep.numel() != shape[dim]:
            raise ValueError(f"{'/'.join(keys)}: {shape[dim]} entries along "
                             f"dim {dim}, padded layout {keep.numel()}")
        return None if bool(keep.all()) else (dim, keep)
    if parent in ("attn", "cross"):
        hd = cfg.resolved_head_dim
        hp, kvp = pad_to(cfg.n_heads, tp), pad_to(cfg.n_kv_heads, tp)
        if parent == "attn" and cfg.attn_kind == "mla":
            vhd = cfg.v_head_dim or hd
            width = {"wq": hd + cfg.rope_head_dim, "uk": hd, "uv": vhd,
                     "wo": vhd}.get(name)
        else:
            width = hd if name in ("wq", "bq", "wo") else None
        if width is not None:
            dim = lead + (0 if name == "wo" or name == "bq" else 1)
            return units(dim, cfg.n_heads, hp, width)
        if name in ("wk", "wv", "bk", "bv"):
            group = hp // kvp
            real = torch.arange(kvp) * group < cfg.n_heads
            return units(lead + (1 if name[0] == "w" else 0), None, kvp, hd,
                         real)
        return None
    if parent == "embed":
        vp = pad_to(cfg.vocab_size, tp)
        return units(0 if name == "tok" else 1, cfg.vocab_size, vp)
    if parent == "moe":
        ep = pad_to(cfg.moe.n_experts, tp)
        if name == "router":
            return units(lead + 1, cfg.moe.n_experts, ep)
        if name in ("gate", "up", "down"):
            return units(lead, cfg.moe.n_experts, ep)
    return None
