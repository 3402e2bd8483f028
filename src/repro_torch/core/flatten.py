"""Tree <-> flat-vector utilities (the port's ``repro.core.flatten``).

A parameter tree is a nested dict (and list) of tensors, laid out as the
reference lays out its pytree. Leaves are ordered as ``jax.tree_util``
orders them: dict keys sorted at every level, list elements in index
order (a model's dense ``prefix`` layers). So flat index i names the same
parameter element in both packages, which every parity test relies on.
A path is a tuple of dict keys and list indices.
"""
from __future__ import annotations

import torch


def tree_items(tree, prefix=()) -> list:
    """[(path, leaf)] in jax.tree_util leaf order (sorted dict keys, list
    elements in order)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, list):
        keys = range(len(tree))
    else:
        return [(prefix, tree)]
    out = []
    for key in keys:
        out.extend(tree_items(tree[key], prefix + (key,)))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, val) for val in tree]
    return fn(tree)


def tree_from_items(items) -> dict:
    """The tree of ``(path, leaf)`` items; a node whose keys are list
    indices becomes a list."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _lists(out)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(key, int) for key in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {key: _lists(val) for key, val in node.items()}


def tree_size(tree) -> int:
    return sum(int(leaf.numel()) for leaf in tree_leaves(tree))


class TreeFlattener:
    """Flattens a parameter tree (or its leaf list, in the same order) to
    one fp32 vector and back. Built once from an example tree."""

    def __init__(self, example_tree):
        items = tree_items(example_tree)
        self.paths = [path for path, _ in items]
        self.shapes = [tuple(leaf.shape) for _, leaf in items]
        self.sizes = [int(leaf.numel()) for _, leaf in items]
        self.offsets = []
        off = 0
        for size in self.sizes:
            self.offsets.append(off)
            off += size
        self.total = off

    def flatten(self, tree_or_leaves) -> torch.Tensor:
        leaves = (tree_or_leaves if isinstance(tree_or_leaves, (list, tuple))
                  else tree_leaves(tree_or_leaves))
        return torch.cat([leaf.reshape(-1).float() for leaf in leaves])

    def flatten_segments(self, tree_or_leaves, bounds) -> list:
        """One flat fp32 vector per segment of ``bounds``, a leaf-aligned
        contiguous partition of [0, total) (``core.allocate.
        layer_segments`` over :meth:`layer_bounds`), each built only from
        that segment's leaves; their concatenation is :meth:`flatten`'s
        vector. Raises on bounds that cut a leaf or miss one."""
        leaves = (tree_or_leaves if isinstance(tree_or_leaves, (list, tuple))
                  else tree_leaves(tree_or_leaves))
        segs, li = [], 0
        for off, size in bounds:
            if li >= len(self.offsets) or self.offsets[li] != off:
                raise ValueError(
                    f"segment offset {off} is not leaf-aligned "
                    f"(leaf offsets: {self.offsets[li:li + 2]}...)")
            parts, have = [], 0
            while have < size:
                parts.append(leaves[li].reshape(-1).float())
                have += self.sizes[li]
                li += 1
            if have != size:
                raise ValueError(
                    f"segment (off={off}, size={size}) cuts inside a leaf")
            segs.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        if li != len(leaves):
            raise ValueError("bounds do not cover every leaf")
        return segs

    def layer_bounds(self) -> list:
        """Per-leaf (offset, size) of the flat vector: what
        ``core.allocate.layer_segments`` groups into layer-aligned
        segments."""
        return list(zip(self.offsets, self.sizes))

    def unflatten(self, vec: torch.Tensor) -> dict:
        """Tree of VIEWS into ``vec`` (no copy)."""
        return tree_from_items(
            (path, vec[off:off + size].view(shape))
            for path, off, size, shape in zip(self.paths, self.offsets,
                                              self.sizes, self.shapes))


def bucket_bounds(j: int, num_buckets: int) -> list:
    """Contiguous near-equal partition of [0, j) into buckets: [(offset,
    size), ...] with sizes differing by at most one, the larger ones
    first, summing to j; num_buckets is clamped to [1, j] (no bucket is
    empty). The reference's rule, so both packages cut alike."""
    b = max(1, min(int(num_buckets), max(j, 1)))
    base, rem = divmod(j, b)
    bounds, off = [], 0
    for i in range(b):
        size = base + (1 if i < rem else 0)
        bounds.append((off, size))
        off += size
    return bounds
