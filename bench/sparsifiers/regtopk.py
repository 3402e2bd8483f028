"""REGTOP-k's state after one step: the error feedback eps^1 = a^0 -
ghat^0 and the payload ghat^0 it sent (its indices and values), so
g^0 = a^0 = eps^1 + ghat^0."""
from __future__ import annotations


def first_dense_gradient(ef: dict):
    g0 = ef["err_prev"].float().clone()
    return g0.index_add_(0, ef["idx_prev"].long() & 0xFFFFFFFF,
                         ef["a_prev_sel"].float())
