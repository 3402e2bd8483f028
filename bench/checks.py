"""The comparison that decides ``correct``: the program's readings of a
cell's first steps against the reference's, each number beside its
limit.

- ``loss_gap``: over the steps, the largest |loss - the reference's| over
  the reference's;
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first aggregate gradient (as Adam got it) and the
  reference's, over the reference's norm of that leaf or of the median
  leaf (of the leaves it moves at all), whichever is larger;
- ``update_gap``: the same of the parameters' change over the steps;
- ``dense_grad_gap`` (with a compressor): the same of the first dense
  gradient, the mean over the ranks of each one's error feedback after
  one step plus the payload it sent;
- ``ranks_differing`` (more than one rank): ranks whose parameters at
  the window's end differ in any bit from rank 0's.

Leaves whose first mean dense gradient in the reference is under a
thousandth of the median leaf's move under Adam by round-off alone and
are left out of both norm gaps.
"""
from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3


def _worst(prog: list, ref: list, keep: list, names: list) -> tuple:
    # a sparse aggregate leaves many leaves at 0: the median leaf is the
    # median of those the reference moves
    moved = [ref[i] for i in keep if ref[i] > 0]
    med = statistics.median(moved) if moved else 0.0
    gaps = [(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30), names[i])
            for i in keep]
    return max(gaps)


def gaps(prog: dict, ref: dict) -> tuple:
    """({number: value}, {number: the leaf or step that set it})."""
    dense = ref["dense_norms"]
    med = statistics.median(dense)
    keep = [i for i, x in enumerate(dense) if x >= NOUGHT * med]
    names = ref["leaves"]
    loss = max((abs(p - r) / abs(r), f"step {t}") for t, (p, r) in
               enumerate(zip(prog["loss"], ref["loss"])))
    grad = _worst(prog["grad_norms"], ref["grad_norms"], keep, names)
    upd = _worst(prog["update_norms"], ref["update_norms"], keep, names)
    values = {"loss_gap": loss[0], "grad_gap": grad[0], "update_gap": upd[0]}
    where = {"loss_gap": loss[1], "grad_gap": grad[1], "update_gap": upd[1]}
    if "dense_grad_norms" in prog:
        dense_gap = _worst(prog["dense_grad_norms"], dense, keep, names)
        values["dense_grad_gap"], where["dense_grad_gap"] = dense_gap
    if "ranks_differing" in prog:
        values["ranks_differing"] = prog["ranks_differing"]
    return values, where


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}): every number at or under
    its limit, none missing and none NaN."""
    table = {name: {"value": values.get(name), "limit": limit}
             for name, limit in limits.items()}
    ok = all(row["value"] is not None and not math.isnan(row["value"])
             and row["value"] <= row["limit"] for row in table.values())
    return ok, table
