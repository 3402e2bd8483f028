"""The paper's own experiments on the port (the counterpart of the
reference's ``benchmarks/paper_experiments.py``), one function a figure:

- ``fig1_toy_logistic`` (§1.2, Fig 1): TOP-1 stalls on a toy logistic
  problem (J = 2, N = 2) while REGTOP-1 tracks dense;
- ``fig2_linreg`` (§4.1, Fig 2): the optimality gap of distributed
  linear regression (N = 20 workers, 500 points, dim 100) at sparsity
  S in {0.4, 0.5, 0.6};
- ``fig3_nn`` (§4.2, Fig 3): the accuracy of the small residual CNN on
  the synthetic 10-class images (the stand-in for ResNet-18 on
  CIFAR-10) at S = 0.001 with N = 8 workers (J = 77,370 at width 16).

Signatures, defaults and return shapes are the reference's, plus
``device`` (None: the CUDA card; raises without one) and fig3's optional
initial ``params``. The rounds go through ``core.sparsify``'s drivers, so
on the card every TOP-k, REGTOP-k and sketch round runs the reference
pipeline's kernels (the apply kernel, the dense score kernel, the
CountSketch encode). The data are the reference's, bit for bit; fig3's
batches are drawn by numpy's ``default_rng(seed)`` in the reference's
order, one stream a kind.

    PYTHONPATH=src python -m repro_torch.paper_experiments [--full] \\
        [--device cpu]

prints what ``examples/paper_validation.py`` prints.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.configs.base import SparsifierConfig
from repro_torch.convert import ravel_cnn, unravel_cnn
from repro_torch.core import sparsify
from repro_torch.data.synthetic import image_dataset, linreg_dataset


# ---------------------------------------------------------------------------
# Fig 1: toy logistic regression (§1.2)
# ---------------------------------------------------------------------------

def fig1_toy_logistic(iters=100, eta=0.9, mu=0.5, Q=0.0, device=None):
    """{kind: [loss after each iteration]} for none, topk, regtopk (k=1)."""
    dev = resolve_device(device)
    xs = [torch.tensor([100.0, 1.0], device=dev),
          torch.tensor([-100.0, 1.0], device=dev)]

    def grad_n(w, xn):
        e = torch.exp(-torch.dot(w, xn))
        return -e * xn / (1 + e)

    def loss(w):
        return 0.5 * sum(torch.log(1 + torch.exp(-torch.dot(w, xn)))
                         for xn in xs)

    out = {}
    for kind in ("none", "topk", "regtopk"):
        cfg = SparsifierConfig(kind=kind, k=1, mu=mu, Q=Q, selector="exact")
        w = torch.tensor([0.0, 1.0], device=dev)
        states = [sparsify.init_state(cfg, 2, dev) for _ in range(2)]
        hist = []
        for _ in range(iters):
            grads = [grad_n(w, xn) for xn in xs]
            if kind == "none":
                g = 0.5 * (grads[0] + grads[1])
            else:
                g, states = sparsify.sparsified_round(cfg, states, grads)
            w = w - eta * g
            hist.append(loss(w))
        out[kind] = torch.stack(hist).tolist()
    return out


# ---------------------------------------------------------------------------
# Fig 2: distributed linear regression (§4.1)
# ---------------------------------------------------------------------------

def fig2_linreg(S_values=(0.4, 0.5, 0.6), iters=3000, eta=1e-2, mu=0.5,
                n_workers=20, n_points=500, dim=100, seed=0,
                kinds=("none", "topk", "regtopk", "sketchtopk"),
                device=None):
    """{(S, kind): [||w - w*|| after each iteration]}."""
    dev = resolve_device(device)
    xs, ys, w_star = linreg_dataset(n_workers, n_points, dim, seed=seed,
                                    device=dev)
    X, Y = torch.stack(xs), torch.stack(ys)          # (N, P, D), (N, P)

    def grad_all(w):
        r = X @ w - Y
        return (X.transpose(1, 2) @ r.unsqueeze(-1)).squeeze(-1) / n_points

    results = {}
    for S in S_values:
        for kind in kinds:
            cfg = SparsifierConfig(kind=kind, sparsity=S, mu=mu,
                                   selector="exact")
            w = torch.zeros(dim, device=dev)
            states = sparsify.stack_states(
                [sparsify.init_state(cfg, dim, dev)
                 for _ in range(n_workers)])
            round_fn = sparsify.make_round_fn(cfg, n_workers)
            gaps = []
            for _ in range(iters):
                grads = grad_all(w)
                if kind == "none":
                    g = grads.mean(0)
                else:
                    g, states = round_fn(states, grads)
                w = w - eta * g
                gaps.append(torch.linalg.norm(w - w_star))
            results[(S, kind)] = torch.stack(gaps).tolist()
    return results


# ---------------------------------------------------------------------------
# Fig 3: DNN on synthetic images (§4.2 analogue)
# ---------------------------------------------------------------------------

def fig3_nn(iters=400, n_workers=8, batch=20, S=0.001, eta=0.01, mu=0.5,
            seed=0, eval_every=50, kinds=("topk", "regtopk"), width=16,
            sketch_rows=3, sketch_width=0, device=None, params=None):
    """{kind: [(iteration, test accuracy), ...]} every ``eval_every``
    iterations. ``params``: the initial CNN parameters (the port's OIHW
    layout, e.g. the reference's carried across by
    ``convert.cnn_params_from_jax``); None draws them from a generator
    seeded with ``seed``."""
    from repro_torch.models.cnn import cnn_accuracy, cnn_grad, init_cnn
    dev = resolve_device(device)
    xtr, ytr, xte, yte = image_dataset(n_train=n_workers * 500, seed=seed,
                                       device=dev)
    # split evenly among workers (paper: data distributed evenly), as
    # np.array_split does
    xw = torch.tensor_split(xtr, n_workers)
    yw = torch.tensor_split(ytr, n_workers)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_cnn(gen, width=width, device=dev)
    p0 = {key: val.to(dev) for key, val in params.items()}
    flat0 = ravel_cnn(p0)
    j = flat0.numel()

    out = {}
    for kind in kinds:
        cfg = SparsifierConfig(kind=kind, sparsity=S, mu=mu, selector="exact",
                               sketch_rows=sketch_rows,
                               sketch_width=sketch_width)
        vec = flat0.clone()
        states = sparsify.stack_states(
            [sparsify.init_state(cfg, j, dev) for _ in range(n_workers)])
        round_fn = (sparsify.make_round_fn(cfg, n_workers)
                    if kind != "none" else None)
        rng = np.random.default_rng(seed)   # identical batch order per kind
        accs = []
        for t in range(iters):
            p = unravel_cnn(vec, p0)
            grads = []
            for n in range(n_workers):
                idx = torch.from_numpy(
                    rng.integers(0, xw[n].shape[0], size=batch)).to(dev)
                grads.append(ravel_cnn(cnn_grad(p, xw[n][idx], yw[n][idx])))
            grads = torch.stack(grads)
            if kind == "none":
                g = grads.mean(0)
            else:
                g, states = round_fn(states, grads)
            vec = vec - eta * g
            if (t + 1) % eval_every == 0:
                accs.append((t + 1, cnn_accuracy(unravel_cnn(vec, p0), xte,
                                                 yte)))
        out[kind] = accs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the published iteration counts (fig2 3000, "
                         "fig3 400) in place of 1000 and 150")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    print("=== Fig 1: toy logistic regression (J=2, N=2, eta=0.9) ===")
    out = fig1_toy_logistic(iters=100, device=args.device)
    stall = sum(1 for v in out["topk"] if abs(v - out["topk"][0]) < 1e-6)
    print(f"TOP-1 stays at the initial loss for {stall} iterations "
          f"(paper: ~50).")
    for t in (0, 5, 20, 99):
        print(f"  iter {t:3d}: dense {out['none'][t]:.4f}  "
              f"top-1 {out['topk'][t]:.4f}  regtop-1 {out['regtopk'][t]:.4f}")

    iters = 3000 if args.full else 1000
    print(f"\n=== Fig 2: linear regression, 20 workers ({iters} iters) ===")
    res = fig2_linreg(iters=iters, device=args.device)
    print(f"{'S':>5} {'dense':>10} {'TOP-k':>10} {'REGTOP-k':>10}")
    for S in (0.4, 0.5, 0.6):
        print(f"{S:5.1f} {res[(S, 'none')][-1]:10.2e} "
              f"{res[(S, 'topk')][-1]:10.2e} {res[(S, 'regtopk')][-1]:10.2e}")

    iters = 400 if args.full else 150
    print(f"\n=== Fig 3 analogue: CNN, N=8, S=0.001 ({iters} iters) ===")
    out = fig3_nn(iters=iters, eval_every=max(iters // 4, 1),
                  device=args.device)
    for kind, accs in out.items():
        tail = "  ".join(f"@{t}: {a:.3f}" for t, a in accs)
        print(f"  {kind:8s} {tail}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
