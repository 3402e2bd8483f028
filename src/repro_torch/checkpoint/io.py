"""Checkpoints: one .npz per state tree plus a JSON manifest (the port of
``repro.checkpoint.io``, in its file format).

``step_%08d.{params,opt,ef}.npz`` hold the leaves under the keys
``jax.tree_util.keystr`` gives their paths (``"['blocks']['l0']['wq']"``,
a list element's index bare: ``"['prefix'][0]['attn']['wq']"``),
and ``step_%08d.json`` the manifest ``{"step"[, "param_version"]}``. So
a checkpoint written by either package restores in the other:

- uint32 leaves (REGTOP-k's ``idx_prev``) are the port's int32 views of
  the same bits; they are written as uint32;
- bf16 leaves are written as their uint16 bits viewed as numpy ``V2``,
  which is what ``np.savez`` of the reference's bf16 arrays writes, and a
  ``V2`` leaf is read back as the template's bf16 (:func:`_fit_dtype`).

The trees are in the reference's global layout: the optimizer and
sparsifier states as ``(DP, TP, ...)`` (``train.step.save_train_state``
builds it from the ranks' slices). Under tensor parallelism the global
parameter tree holds one copy of each leaf replicated over the model
group (model rank 0's, as the reference's ``np.asarray`` of a replicated
array does), though the ranks' copies drift apart under a sparsified
sync; ``step_%08d.replicated.npz`` keeps every model rank's copy,
stacked ``(TP, ...)`` under the same keys (``save_checkpoint``'s
``replicated``), and the port's restore gives each rank its own
(:func:`load_replicated`). The reference reads the three trees and
ignores that file. Every file is written a leaf at a time
(:func:`_write_npz`, ``np.savez``'s format), so a writer that gathers
its leaves from other ranks holds one leaf at a time. A restore
fits a saved EF leaf to a changed worker count
(:func:`_fit_ef_worker_dims`) and migrates the legacy ``(a_prev,
s_prev)`` pair to ``err_prev`` (:func:`_migrate_ef_leaf`).
"""
from __future__ import annotations

import json
import os
import re
import zipfile

import numpy as np
import torch

from repro_torch.convert import bf16_bits, bf16_from_bits
from repro_torch.core.flatten import tree_from_items, tree_items

UINT32_KEYS = ("idx_prev",)      # the port's int32 views of uint32 bits


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list
    indices."""
    return "".join(f"[{key!r}]" for key in path)


def _to_numpy(path, leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    if leaf.dtype == torch.bfloat16:
        return bf16_bits(leaf).view("V2")
    a = leaf.detach().cpu().numpy()
    return a.view(np.uint32) if path and path[-1] in UINT32_KEYS else a


def _items(tree):
    """A tree's (path, leaf) pairs; an iterator of pairs as it is."""
    return tree_items(tree) if isinstance(tree, dict) else tree


def _write_npz(fname: str, items) -> None:
    """``np.savez``'s file of (path, leaf) pairs under their
    :func:`keystr` keys, written a leaf at a time: each pair is converted
    and stored before the next is drawn."""
    with zipfile.ZipFile(fname, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for path, leaf in items:
            with zf.open(keystr(path) + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _to_numpy(path, leaf),
                                          allow_pickle=False)


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state, ef_state,
                    param_version=None, replicated=None) -> str:
    """Write the three trees (tensors or numpy leaves), ``replicated``
    where given (every model rank's copy of the replicated parameter
    leaves, ``(TP, ...)``), and the manifest. Each tree may be an
    iterator of (path, leaf) pairs, drawn in that order (params, opt,
    ef, replicated) and a leaf at a time. ``param_version`` stamps the
    delta broadcast's version these params are at: a replica restored
    from it takes it as its version floor."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    for suffix, tree in ((".params.npz", params), (".opt.npz", opt_state),
                         (".ef.npz", ef_state),
                         (".replicated.npz", replicated)):
        if tree is not None:
            _write_npz(path + suffix, _items(tree))
    manifest = {"step": step}
    if param_version is not None:
        manifest["param_version"] = int(param_version)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    return path


def load_replicated(path: str, tp: int) -> dict:
    """{path tuple: (TP, ...) array} of the checkpoint at ``path``'s
    per-rank replicated leaves; {} where it has none (a one-rank
    checkpoint, or the reference's). ValueError for copies of another
    model group's size."""
    fname = path + ".replicated.npz"
    if not os.path.exists(fname):
        return {}
    out = {}
    with np.load(fname) as data:
        for key in data.files:
            leaf = data[key]
            if leaf.shape[0] != tp:
                raise ValueError(f"{fname}: {key} holds {leaf.shape[0]} "
                                 f"model ranks' copies, the run has {tp}")
            out[_path_of(key)] = _fit_dtype(leaf)
    return out


def _path_of(key: str) -> tuple:
    """The path tuple of a :func:`keystr` key (dict keys as strings,
    list indices as ints)."""
    return tuple(int(k) if k.isdigit() else k.strip("'")
                 for k in re.findall(r"\[([^\]]*)\]", key))


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.json", f))]
    return max(steps) if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """The checkpoint's manifest. One without ``param_version`` is
    unstamped: ``manifest.get("param_version")`` is None."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}.json")) as f:
        return json.load(f)


def _migrate_ef_leaf(data, pstr: str) -> np.ndarray:
    """One EF leaf of a saved npz; the legacy ``(a_prev, s_prev)`` pair
    becomes ``err_prev = a_prev * (1 - s_prev)`` (one dense multiply)."""
    if pstr in data.files:
        return data[pstr]
    if "err_prev" in pstr:
        pa = pstr.replace("err_prev", "a_prev")
        ps = pstr.replace("err_prev", "s_prev")
        if pa in data.files and ps in data.files:
            a = data[pa]
            s = data[ps]
            return (a.astype(np.float32)
                    * (1.0 - s.astype(np.float32))).astype(a.dtype)
    raise KeyError(
        f"checkpoint is missing EF leaf {pstr!r} and no legacy "
        "(a_prev, s_prev) pair to migrate it from")


def _fit_ef_worker_dims(leaf: np.ndarray, want_shape, pstr: str):
    """Fit a saved ``(DP, TP, J_local)`` EF leaf to the run's worker
    layout. When only the leading worker dims differ, the surviving
    workers keep their rows and new workers start from zero error
    feedback (a fresh worker observed nothing); a trailing-dim mismatch
    means another model and raises."""
    if tuple(leaf.shape) == tuple(want_shape):
        return leaf
    if (leaf.ndim == len(want_shape) and leaf.ndim >= 3
            and tuple(leaf.shape[2:]) == tuple(want_shape[2:])):
        out = np.zeros(want_shape, leaf.dtype)
        d = min(leaf.shape[0], want_shape[0])
        t = min(leaf.shape[1], want_shape[1])
        out[:d, :t] = leaf[:d, :t]
        return out
    raise ValueError(
        f"checkpoint EF leaf {pstr!r} has shape {tuple(leaf.shape)} but the "
        f"run wants {tuple(want_shape)}; only the leading (DP, TP) worker "
        "dims may differ (elastic resume), the trailing per-rank dims must "
        "match")


def _fit_dtype(leaf: np.ndarray, dtype=torch.bfloat16):
    """A ``V2`` leaf (npz's form of bf16, the only one this format
    writes) as a bf16 tensor (a view of the bits, not a cast) where
    ``dtype`` is bf16; any other leaf as it is."""
    if (leaf.dtype.kind == "V" and dtype == torch.bfloat16
            and leaf.dtype.itemsize == 2):
        return bf16_from_bits(leaf)
    return leaf


def load_leaves(fname: str, tree, migrate_ef: bool = False):
    """(path, leaf, template leaf) of ``fname`` in the order of
    ``tree``'s leaves (tensors of any device, ``meta`` included), a leaf
    at a time: numpy arrays, EF leaves migrated and fitted to the
    template's shapes, and a ``V2`` leaf as a bf16 CPU tensor where the
    template is bf16."""
    with np.load(fname) as data:
        for path, tmpl in tree_items(tree):
            pstr = keystr(path)
            if migrate_ef:
                leaf = _migrate_ef_leaf(data, pstr)
                if tmpl.ndim >= 3:
                    leaf = _fit_ef_worker_dims(leaf, tuple(tmpl.shape), pstr)
            else:
                leaf = data[pstr]
            yield path, _fit_dtype(leaf, tmpl.dtype), tmpl


def load_items(fname: str):
    """(path, leaf) of every leaf of ``fname`` in the file's order, a
    leaf at a time: numpy arrays, a ``V2`` leaf as a bf16 CPU tensor."""
    with np.load(fname) as data:
        for key in data.files:
            yield _path_of(key), _fit_dtype(data[key])


def to_tensor(leaf, tmpl: torch.Tensor, device=None) -> torch.Tensor:
    """A loaded leaf as a tensor on ``device`` (default: the template
    leaf's); uint32 as its int32 bits."""
    if not isinstance(leaf, torch.Tensor):
        leaf = np.asarray(leaf, order="C")
        leaf = torch.from_numpy(leaf.view(np.int32) if leaf.dtype ==
                                np.uint32 else leaf)
    return leaf.to(tmpl.device if device is None else device)


def restore_checkpoint(ckpt_dir: str, step: int, params, opt_state,
                       ef_state, device=None):
    """Restore into the structure of the given trees (values replaced):
    tensors of the saved dtypes (a ``V2`` leaf as the template's bf16,
    uint32 as its int32 view) on ``device``, by default each template
    leaf's own. The EF tree tolerates a changed data-parallel worker
    count (:func:`_fit_ef_worker_dims`)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")

    def load(tree, suffix, migrate_ef=False):
        return tree_from_items(
            (p, to_tensor(leaf, tmpl, device)) for p, leaf, tmpl in
            load_leaves(path + suffix, tree, migrate_ef))

    return (load(params, ".params.npz"), load(opt_state, ".opt.npz"),
            load(ef_state, ".ef.npz", migrate_ef=True))
