"""The weights of a cell, made by the benchmark from the seed on the card.

The tree's layout is its family's (``bench/families/<family>.py``,
``leaf_specs``). One generator on the device draws every random leaf in
one call; the leaves are views of one flat fp32 vector laid out in the
program's flat order (dict keys sorted at every level), so the
program's flattening and the reference's read the same element at the
same index. Both sides get this tree: the program through
``init_train_state(params=...)``, the reference as its weights.
"""
from __future__ import annotations

import math

import torch


def n_params(specs: list) -> int:
    return sum(math.prod(shape) for _, shape, _ in specs)


def make_weights(specs: list, seed: int, device) -> dict:
    """The tree {path...: leaf} of fp32 views into one flat vector, drawn
    from ``seed`` on ``device``; ``specs`` the family's
    [(path, shape, init)]."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    tree: dict = {}
    off = 0
    for (path, shape, init), size in zip(specs, sizes):
        leaf = flat[off:off + size].view(shape)
        off += size
        if init == "normal":
            leaf.mul_(shape[-2] ** -0.5)
        elif init == "table":
            leaf.mul_(0.02)
        else:
            leaf.fill_(1.0 if init == "ones" else 0.0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaf_items(tree: dict, prefix=()) -> list:
    """[(path, leaf)] in flat order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(leaf_items(tree[key], prefix + (key,)))
    return out
