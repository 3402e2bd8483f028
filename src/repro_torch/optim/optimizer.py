"""Optimizers over flat fp32 vectors with ZeRO-1 sharding (the port of
``repro.optim.optimizer``): sgd, momentum, adam and adamw, with weight
decay (adamw only), global-norm gradient clipping and a warmup plus
constant or cosine learning-rate schedule.

Each of the DP data ranks owns a 1/DP slice of (master, m, v); after the
gradient sync every rank updates its slice and the master is all-gathered
back. States are fp32. Updates are out of place: the old master stays
valid (the step's parameters may be views of it) until the new one
replaces it.

The compiled reference contracts each multiply that feeds an add into a
fused multiply-add. sgd and momentum follow it (``numerics.fma_f32``)
and, at a constant rate, are bitwise with it; a Python scalar divided by
a tensor is a true division here (torch's ``scalar / tensor`` multiplies
by the reciprocal). adam and adamw round each operation on its own and
agree to a tolerance (their fp32 ``pow`` differs from XLA's anyway); so
the card's Adam step stays in plain fp32 passes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.numerics import fma_f32, norm_f32

KINDS = ("sgd", "momentum", "adam", "adamw")


def check_optimizer(cfg: OptimizerConfig) -> None:
    """An unknown kind raises ValueError, as the reference's does.
    ``zero1`` is not read: the state is sharded whatever its value, as
    the reference shards it."""
    if cfg.kind not in KINDS:
        raise ValueError(cfg.kind)


def opt_shard_len(j_local: int, dp: int) -> int:
    """Padded per-data-rank slice length."""
    return -(-j_local // dp)


def lr_at_step(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d integer tensor) as an fp32
    scalar on its device: linear warmup over ``warmup_steps``, then a
    constant rate or a cosine decay to 0 at ``total_steps``."""
    step = step.float()
    lr = torch.full_like(step, cfg.lr)
    if cfg.warmup_steps:
        lr = lr * ((step + 1) / cfg.warmup_steps).clamp(max=1.0)
    if cfg.schedule == "cosine":
        t = ((step - cfg.warmup_steps)
             / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
        lr = lr * (0.5 * (1.0 + torch.cos(math.pi * t)))
    return lr


def init_opt_state(cfg: OptimizerConfig, master_slice: torch.Tensor) -> dict:
    """State for one rank's slice. master_slice: (shard,) fp32 params."""
    check_optimizer(cfg)
    st = {"master": master_slice,
          "step": torch.zeros((), dtype=torch.int32,
                              device=master_slice.device)}
    if cfg.kind != "sgd":
        st["m"] = torch.zeros_like(master_slice)
    if cfg.kind in ("adam", "adamw"):
        st["v"] = torch.zeros_like(master_slice)
    return st


def apply_updates(cfg: OptimizerConfig, state: dict, g_slice: torch.Tensor):
    """One optimizer step on this rank's slice. With ``grad_clip`` the
    caller passes the global gradient norm as ``state["gnorm"]`` (else
    the slice's own norm is used). Returns (new_master, state)."""
    check_optimizer(cfg)
    m0 = state["master"]
    step = state["step"]
    g = g_slice.float()
    if cfg.grad_clip:
        gn = state.get("gnorm")
        if gn is None:
            gn = norm_f32(g)
        clip = torch.full_like(gn, cfg.grad_clip) / gn.clamp(min=1e-12)
        g = g * clip.clamp(max=1.0)
    new = dict(state)
    new.pop("gnorm", None)
    lr = lr_at_step(cfg, step)
    if cfg.kind in ("sgd", "momentum"):
        upd = g
        if cfg.kind == "momentum":
            upd = new["m"] = fma_f32(state["m"], cfg.momentum, g)
        master = fma_f32(upd, -lr, m0)
    else:
        t = (step + 1).float()
        m = cfg.b1 * state["m"] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"] + (1 - cfg.b2) * g * g
        mhat = m / (1 - torch.pow(cfg.b1, t))
        vhat = v / (1 - torch.pow(cfg.b2, t))
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        new["m"], new["v"] = m, v
        if cfg.weight_decay and cfg.kind == "adamw":
            upd = upd + cfg.weight_decay * m0
        master = m0 - lr * upd
    new["master"] = master
    new["step"] = step + 1
    return master, new
