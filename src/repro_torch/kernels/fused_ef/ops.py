"""The dense reference-layout REGTOP-k passes as the reference pipeline
calls them (the port of ``repro.kernels.fused_ef.ops``).

These serve the reference pipeline's DENSE REGTOP-k layout (a_prev,
s_prev and g_agg_prev J-vectors, ``state_format="dense"``), not the
fused two-sweep pipeline. Unlike the reference's wrappers nothing is
padded: the kernels take any J.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_ef import kernel


def fused_regtopk_scores(g, err, a_prev, g_agg, s_prev, *, omega, mu, Q):
    """(a, score) for the REGTOP-k selector; inputs (J,), cast to fp32,
    or with a bf16 error state the bf16 read (g cast to fp32, the state
    vectors bf16; a bf16, the score fp32 holding bf16 values)."""
    if err.dtype == torch.bfloat16:
        return kernel.scores_bf16(
            g.float().contiguous(),
            *(x.contiguous() for x in (err, a_prev, g_agg, s_prev)),
            omega=float(omega), mu=float(mu), Q=float(Q))
    return kernel.scores(*(x.float().contiguous() for x in
                           (g, err, a_prev, g_agg, s_prev)),
                         omega=float(omega), mu=float(mu), Q=float(Q))


def fused_apply_mask(a, mask):
    """(ghat, err_new) = (mask * a, a - mask * a)."""
    return kernel.apply(a.float().contiguous(), mask.float().contiguous())
