"""Dense decoder transformer (the port of ``repro.models.transformer`` for
the dense family at tensor-parallel degree 1).

Parameter tree, in the reference's layout so that the flat vector of both
packages lines up element for element::

    blocks/l0/{attn/{wk,wo,wq,wv}, mlp/{down,gate,up}, norm1/..., norm2/...}
    embed/{head,tok}
    final_norm/{bias,scale}

Every ``blocks`` leaf holds all layers along a leading axis (the
reference's ``jax.lax.scan`` stack). The forward unbinds that axis once,
so each stacked leaf's gradient is assembled by one ``stack`` rather than
one full-size scatter per layer, and recomputes each layer in the
backward pass (``torch.utils.checkpoint``) when ``cfg.remat``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.flatten import tree_from_items, tree_items
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    embed_fwd, init_embed, init_mlp, init_norm, lm_head_fwd, mlp_fwd,
    norm_fwd, sharded_xent,
)

LOSS_CHUNK = 512


# (field, value the port serves, ROADMAP item that ports the rest)
_SLICE = (("family", "dense", "A13"), ("norm", "layernorm", "A7"),
          ("act", "silu", "A7"), ("rope", True, "A7"),
          ("qkv_bias", False, "A7"), ("tie_embeddings", False, "A7"))


def check_model(cfg) -> None:
    """Raise NotImplementedError for a model outside the ported slice."""
    for field, served, item in _SLICE:
        if getattr(cfg, field) != served:
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported "
                f"yet; the port serves {served!r} (ROADMAP {item})")


def init_params(cfg, gen: torch.Generator, device=None) -> dict:
    """Random fp32 parameters drawn from ``gen`` (on ``device``)."""
    check_model(cfg)
    lead = (cfg.n_layers,)
    layer = {"norm1": init_norm(cfg, lead=lead, device=device),
             "attn": attn.init_attention(gen, cfg, lead=lead, device=device),
             "norm2": init_norm(cfg, lead=lead, device=device),
             "mlp": init_mlp(gen, cfg, lead=lead, device=device)}
    return {"embed": init_embed(gen, cfg, device=device),
            "blocks": {"l0": layer},
            "final_norm": init_norm(cfg, device=device)}


def _layer_fwd(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    x = x + attn.attn_fwd_full(p["attn"], norm_fwd(p["norm1"], x), cfg)
    return x + mlp_fwd(p["mlp"], norm_fwd(p["norm2"], x))


def layer_views(blocks: dict, n_layers: int) -> list:
    """Per-layer parameter trees of views into the stacked leaves."""
    unbound = [(path, leaf.unbind(0)) for path, leaf in tree_items(blocks)]
    return [tree_from_items((path, views[i]) for path, views in unbound)
            for i in range(n_layers)]


def forward_hidden(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layer_views(params["blocks"], cfg.n_layers):
        if remat:
            x = checkpoint(_layer_fwd, lp["l0"], x, cfg, use_reentrant=False)
        else:
            x = _layer_fwd(lp["l0"], x, cfg)
    return norm_fwd(params["final_norm"], x)


def chunked_xent(params: dict, x: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over targets >= 0, chunked over seq."""
    s = x.shape[1]
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        chunk = s
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for off in range(0, s, chunk):
        tc = targets[:, off:off + chunk]
        logits = lm_head_fwd(params["embed"], x[:, off:off + chunk])
        valid = (tc >= 0).float()
        nll = sharded_xent(logits, tc.clamp(min=0))
        tot = tot + (nll * valid).sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp(min=1.0)


def loss_fn(params: dict, batch: dict, cfg) -> torch.Tensor:
    """batch: tokens (B, S) int64; targets (B, S) int64, -1 = masked."""
    check_model(cfg)
    x = embed_fwd(params["embed"], batch["tokens"], cfg)
    x = forward_hidden(params, x, cfg)
    return chunked_xent(params, x, batch["targets"])
