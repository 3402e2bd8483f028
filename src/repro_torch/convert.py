"""Carry weights and state between the reference and the port.

The reference's trees arrive as numpy trees (``jax.device_get`` output);
the port's are nested dicts of tensors in the same layout, so parameters
and fp32 state move as they are. Two translations: the index dtype (the
reference's uint32 indices become the port's int32 view of the same
bits, ``core.bigvec``, and back), and the CNN's convolution weights,
HWIO in the reference and OIHW in the port (``models.cnn``).

The CNN's flat J-vector (:func:`ravel_cnn`, :func:`unravel_cnn`) is in
the order of the reference's ``jax.flatten_util.ravel_pytree`` over its
parameter dict: sorted keys, each leaf flattened C-order in its HWIO
layout. So index i names the same weight in both packages, and
selection, tie order, the posterior and the sketch's hashes agree.
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


def _is_conv(leaf) -> bool:
    return leaf.ndim == 4


def cnn_params_from_jax(tree, device="cpu") -> dict:
    """The reference's CNN parameters (numpy, HWIO) -> the port's (OIHW)."""
    return {key: _to_tensor(np.transpose(val, (3, 2, 0, 1))
                            if _is_conv(np.asarray(val)) else val,
                            device).float()
            for key, val in tree.items()}


def cnn_params_to_jax(params: dict) -> dict:
    """The port's CNN parameters (OIHW) -> numpy in the reference's HWIO."""
    return {key: _to_numpy(val.permute(2, 3, 1, 0) if _is_conv(val)
                           else val)
            for key, val in params.items()}


def ravel_cnn(params: dict) -> torch.Tensor:
    """The CNN parameters (or their gradients) as one fp32 J-vector in the
    reference's ravel order."""
    return torch.cat([(params[key].permute(2, 3, 1, 0)
                       if _is_conv(params[key]) else params[key]).reshape(-1)
                      for key in sorted(params)])


def unravel_cnn(vec: torch.Tensor, like: dict) -> dict:
    """Inverse of :func:`ravel_cnn`: the J-vector back into parameters of
    ``like``'s shapes (OIHW, contiguous)."""
    out, pos = {}, 0
    for key in sorted(like):
        shape = like[key].shape
        n = like[key].numel()
        leaf = vec[pos:pos + n]
        if len(shape) == 4:
            o, i, kh, kw = shape
            leaf = leaf.reshape(kh, kw, i, o).permute(3, 2, 0, 1)
        out[key] = leaf.reshape(shape).contiguous()
        pos += n
    if pos != vec.numel():
        raise ValueError(f"J-vector of {vec.numel()} for {pos} parameters")
    return out
