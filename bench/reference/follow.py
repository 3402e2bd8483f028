"""The reference of a cell's first training steps: each worker's loss and
gradient over its rows, the sparsifier's exchange and the mean combine,
and the optimizer, over the whole flat vector on one card. The model,
the sparsifier and the optimizer are the modules the harness found by
name (``models/<family>.py``, ``sparsifiers/<kind>.py``,
``optimizers/<kind>.py``). Its readings have the form the harness reads
off the program (``bench.cell``):

    loss              the mean over the workers of their losses, each step
    grad_norms        per leaf, the norm of the first aggregate gradient
    update_norms      per leaf, the norm of the parameters' change over
                      the steps
    dense_norms       per leaf, the norm of the first mean dense gradient
                      (the rule that leaves out the leaves the optimizer
                      moves by round-off alone reads it)
    dense_grad_norms  the same, in the program's place (the program
                      works its own out from its compressor's state)

``fault`` plants one of the faults a run can have in the reference put
in the program's place: "half_batch" (each worker's loss is the mean
over the first half of its batch's tokens alone: with one row, the
first half of its positions), "no_exchange" (worker 0 combines its own
payload alone; its readings are given), "unchanged" (each step returns
its state unchanged: the losses are those of the first parameters, and
the state read after a step holds no gradient). Imports nothing but
torch and the reference's own modules.
"""
from __future__ import annotations

import torch

from bench.reference.linear import exact_matmuls

FAULTS = ("", "half_batch", "no_exchange", "unchanged")


def _items(tree: dict, prefix=()) -> list:
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(_items(tree[key], prefix + (key,)))
    return out


def _tree(items) -> dict:
    out: dict = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def leaf_norms(vec: torch.Tensor, sizes: list) -> list:
    out, off = [], 0
    for size in sizes:
        seg = vec[off:off + size]
        out.append(float(seg.float().square().sum(dtype=torch.float64))
                   ** 0.5)
        off += size
    return out


def first_half(targets: torch.Tensor) -> torch.Tensor:
    """The targets with those of the second half of the batch's tokens
    (in row-major order) masked."""
    flat = targets.reshape(-1).clone()
    flat[flat.numel() // 2:] = -1
    return flat.view(targets.shape)


def gradient(flat: torch.Tensor, paths, shapes, sizes, tokens, targets,
             cfg: dict, mode: str, model) -> tuple:
    """(flat gradient of the mean loss over the rows' targets, that
    mean), one row at a time."""
    offs = [0]
    for size in sizes[:-1]:
        offs.append(offs[-1] + size)
    leaves = [flat[o:o + n].view(s).detach().requires_grad_(True)
              for o, n, s in zip(offs, sizes, shapes)]
    tree = _tree(zip(paths, leaves))
    count = int((targets >= 0).sum())
    g = torch.zeros_like(flat)
    total = 0.0
    for row in range(tokens.shape[0]):
        s, _ = model.nll_sum(tree, tokens[row:row + 1],
                             targets[row:row + 1], cfg, mode)
        grads = torch.autograd.grad(s / count, leaves)
        for o, n, gr in zip(offs, sizes, grads):
            g[o:o + n] += gr.reshape(-1)
        total += float(s.detach())
        del grads, s
    return g, total / count


def follow(cfg: dict, job: dict, weights: dict, batches: list, ranks: int,
           steps: int = 3, mode: str = "fp32", fault: str = "", *,
           model, sparsifier, optimizer) -> dict:
    """The readings of ``steps`` steps from ``weights`` (the benchmark's
    tree, not modified) on the global ``batches`` [(tokens, targets)],
    each worker r taking rows [r B/ranks, (r + 1) B/ranks)."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} {FAULTS}")
    exact_matmuls()
    items = _items(weights)
    paths = [p for p, _ in items]
    shapes = [tuple(leaf.shape) for _, leaf in items]
    sizes = [leaf.numel() for _, leaf in items]
    p0 = torch.cat([leaf.reshape(-1).float() for _, leaf in items])
    params = p0.clone()
    dev = params.device
    j = params.numel()
    opt = optimizer.Optimizer(params, job["optimizer"])
    workers = list(range(1 if fault == "no_exchange" else ranks))
    state = {r: sparsifier.Worker(j, job["sparsifier"], 1.0 / ranks, dev)
             for r in workers}
    out = {"loss": []}
    for t in range(steps):
        tokens, targets = batches[t]
        rows = tokens.shape[0] // ranks
        loss, payloads = 0.0, []
        mean0 = torch.zeros(j, device=dev) if t == 0 else None
        for r in workers:
            sl = slice(r * rows, (r + 1) * rows)
            tgt = first_half(targets[sl]) if fault == "half_batch" \
                else targets[sl]
            g, lr_loss = gradient(params, paths, shapes, sizes, tokens[sl],
                                  tgt, cfg, mode, model)
            loss += lr_loss / len(workers)
            if mean0 is not None:
                mean0.add_(g, alpha=1.0 / len(workers))
            if fault != "unchanged":
                payloads.append(state[r].compress(g))
            del g
        if fault == "unchanged":
            agg = torch.zeros(j, device=dev)
        else:
            agg = sparsifier.combine(payloads, j, dev)
            for r in workers:
                state[r].observe(agg)
        if t == 0:
            out["grad_norms"] = leaf_norms(agg, sizes)
            out["dense_norms"] = leaf_norms(mean0, sizes)
            out["dense_grad_norms"] = [0.0] * len(sizes) \
                if fault == "unchanged" else out["dense_norms"]
            del mean0
        out["loss"].append(loss)
        if fault != "unchanged":
            opt.step(agg)
        del agg, payloads
    out["update_norms"] = leaf_norms(params - p0, sizes)
    out["leaves"] = ["/".join(p) for p in paths]
    return out
