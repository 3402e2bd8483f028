"""Carry weights and state between the reference and the port.

The reference's trees arrive as numpy trees (``jax.device_get`` output);
the port's are nested dicts of tensors in the same layout, so parameters
and fp32 state move as they are. The one translation is the index dtype:
the reference's uint32 indices become the port's int32 view of the same
bits (``core.bigvec``), and back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flatten import tree_map


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor, uint_keys=False) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint_keys else a


def params_from_jax(tree, device="cpu") -> dict:
    """Reference parameter tree (numpy leaves) -> port tree of tensors."""
    return tree_map(lambda x: _to_tensor(x, device).float(), tree)


def params_to_jax(params: dict) -> dict:
    """Port parameter tree -> numpy tree in the reference's layout."""
    return tree_map(_to_numpy, params)


def state_from_jax(state: dict, device="cpu") -> dict:
    """Sparsifier or optimizer state (a flat dict of arrays) -> tensors.
    Sparsifier keys: the fused layout's ``err_prev`` or the reference
    layout's ``err``, DGC's momentum ``mom``, REGTOP-k's dense posterior
    ``a_prev``/``s_prev``/``g_agg_prev`` or its O(k) one
    ``idx_prev``/``a_prev_sel``/``g_prev_sel``, and ``step``; optimizer
    keys: ``master``, the moments ``m`` (momentum, adam, adamw) and ``v``
    (adam, adamw), and ``step``. Float state is fp32 and moves as it is;
    uint32 index arrays become int32 views of the same bits."""
    return {key: _to_tensor(val, device) for key, val in state.items()}


def state_to_jax(state: dict) -> dict:
    """Inverse of :func:`state_from_jax`: ``idx_prev`` back to uint32."""
    return {key: _to_numpy(val, uint_keys=key == "idx_prev")
            for key, val in state.items()}
