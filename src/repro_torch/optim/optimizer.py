"""Adam over flat fp32 vectors with ZeRO-1 sharding (the port of
``repro.optim.optimizer`` for what the slice runs: Adam at a constant
learning rate; the other optimizers and schedules are ROADMAP A7).

Each of the DP data ranks owns a 1/DP slice of (master, m, v); after the
gradient sync every rank updates its slice and the master is all-gathered
back. Updates are out of place: the old master stays valid (the step's
parameters may be views of it) until the new one replaces it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig


def check_optimizer(cfg: OptimizerConfig) -> None:
    if cfg.kind != "adam":
        raise NotImplementedError(
            f"optimizer {cfg.kind!r} is not ported yet; the port serves "
            "'adam' (ROADMAP A7)")


def opt_shard_len(j_local: int, dp: int) -> int:
    """Padded per-data-rank slice length."""
    return -(-j_local // dp)


def lr_at_step(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` as an fp32 device scalar (constant)."""
    return torch.full_like(step, cfg.lr, dtype=torch.float32)


def init_opt_state(cfg: OptimizerConfig, master_slice: torch.Tensor) -> dict:
    """State for one rank's slice. master_slice: (shard,) fp32 params."""
    check_optimizer(cfg)
    return {"master": master_slice,
            "step": torch.zeros((), dtype=torch.int32,
                                device=master_slice.device),
            "m": torch.zeros_like(master_slice),
            "v": torch.zeros_like(master_slice)}


def apply_updates(cfg: OptimizerConfig, state: dict, g_slice: torch.Tensor):
    """One Adam step on this rank's slice. Returns (new_master, state)."""
    check_optimizer(cfg)
    step = state["step"]
    g = g_slice.float()
    t = (step + 1).float()
    m = cfg.b1 * state["m"] + (1 - cfg.b1) * g
    v = cfg.b2 * state["v"] + (1 - cfg.b2) * g * g
    mhat = m / (1 - torch.pow(cfg.b1, t))
    vhat = v / (1 - torch.pow(cfg.b2, t))
    upd = mhat / (torch.sqrt(vhat) + cfg.eps)
    master = state["master"] - lr_at_step(cfg, step) * upd
    return master, {"master": master, "step": step + 1, "m": m, "v": v}
