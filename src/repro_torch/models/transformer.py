"""Dense decoder transformer (the port of ``repro.models.transformer`` for
the dense family at tensor-parallel degree 1): training loss, prefill and
cached decode.

Parameter tree, in the reference's layout so that the flat vector of both
packages lines up element for element::

    blocks/l0/{attn/{[bk,] wk, wo, [bq,] wq, [bv,] wv},
               mlp/{down, gate, up} | mlp/{down, down_b, up, up_b},
               norm1/{[bias,] scale}, norm2/{[bias,] scale}}
    embed/{[head,] tok}
    final_norm/{[bias,] scale}

(bracketed leaves by layout: QKV bias, layernorm, untied embeddings).
Every ``blocks`` leaf holds all layers along a leading axis (the
reference's ``jax.lax.scan`` stack). The forward unbinds that axis once,
so each stacked leaf's gradient is assembled by one ``stack`` rather than
one full-size scatter per layer, and recomputes each layer in the
backward pass (``torch.utils.checkpoint``) when ``cfg.remat``.

The decode cache keeps the reference's tree too, ``{pos, blocks/l0/{k,
v}}`` with the layer axis leading on k and v, so a cache crosses between
the packages (``convert.cache_from_jax``). ``pos`` is a 0-d int32 tensor
on the device: decode reads it there, and no step waits on the host.
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


# (field, values the port serves, ROADMAP item that ports the rest)
_SLICE = (("family", ("dense",), "A13"),
          ("attn_kind", ("full", "sliding"), "A13"))


def check_model(cfg) -> None:
    """Raise NotImplementedError for a model outside the ported slice."""
    for field, served, item in _SLICE:
        value = getattr(cfg, field)
        if value not in served:
            raise NotImplementedError(
                f"{cfg.name}: {field}={value!r} is not ported yet; the port "
                f"serves {served} (ROADMAP {item})")


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
    x = x + attn.attn_fwd_full(p["attn"], norm_fwd(p["norm1"], x, cfg.norm),
                               cfg)
    return x + mlp_fwd(p["mlp"], norm_fwd(p["norm2"], x, cfg.norm), cfg)


def layer_views(blocks: dict, n_layers: int) -> list:
    """Per-layer trees of views into the stacked leaves (parameters or a
    decode cache's k and v)."""
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
    return norm_fwd(params["final_norm"], x, cfg.norm)


def sinusoidal(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(len(pos), d) fp32 absolute positions: sin at even dims, cos at odd
    ones, of pos / 10000^(2i/d) (the reference's ``_sinusoidal``)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[:, None] / torch.pow(torch.tensor(
        10000.0, device=pos.device), dim / d)
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(
        pos.shape[0], d)


def embed_batch(params: dict, tokens: torch.Tensor, cfg,
                pos0=None) -> torch.Tensor:
    """tokens (B, S) -> x (B, S, d) in the model's dtype, with the
    sinusoidal positions added when the model has no RoPE. ``pos0`` (a
    0-d device tensor) is the first token's position, 0 by default."""
    x = embed_fwd(params["embed"], tokens, cfg)
    if not cfg.rope:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        if pos0 is not None:
            pos = pos + pos0
        x = x + sinusoidal(pos, cfg.d_model).to(x.dtype)
    return x


def chunked_xent(params: dict, x: torch.Tensor, targets: torch.Tensor,
                 cfg) -> torch.Tensor:
    """Mean next-token cross-entropy over targets >= 0, chunked over seq."""
    s = x.shape[1]
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        chunk = s
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for off in range(0, s, chunk):
        tc = targets[:, off:off + chunk]
        logits = lm_head_fwd(params["embed"], x[:, off:off + chunk], cfg)
        valid = (tc >= 0).float()
        nll = sharded_xent(logits, tc.clamp(min=0))
        tot = tot + (nll * valid).sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp(min=1.0)


def loss_fn(params: dict, batch: dict, cfg) -> torch.Tensor:
    """batch: tokens (B, S) int64; targets (B, S) int64, -1 = masked."""
    check_model(cfg)
    x = embed_batch(params, batch["tokens"], cfg)
    x = forward_hidden(params, x, cfg)
    return chunked_xent(params, x, batch["targets"], cfg)


def full_logits(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Logits (B, S, V) of the whole sequence, no cache: what prefill and
    decode are held against."""
    check_model(cfg)
    x = forward_hidden(params, embed_batch(params, tokens, cfg), cfg)
    return lm_head_fwd(params["embed"], x, cfg)


# ---------------------------------------------------------------------------
# Serving: prefill + decode (call under torch.inference_mode)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg, batch: int, max_seq: int, dtype,
                      device=None, pal=None) -> dict:
    """Zero cache tree for ``batch`` sequences of up to ``max_seq``
    positions (a sliding model keeps min(window, max_seq) slots); with
    ``pal.cache_seq_sharded`` this rank's slice of those slots, which
    must split evenly over the group."""
    check_model(cfg)
    slots = attn.cache_max_seq(cfg, max_seq)
    if pal is not None and pal.cache_seq_sharded:
        slots = cache_slice_len(slots, pal.size)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "blocks": {"l0": attn.init_cache(
                cfg, batch, slots, dtype, lead=(cfg.n_layers,),
                device=device)}}


def cache_slice_len(slots: int, n: int) -> int:
    """One rank's slots of a cache of ``slots`` split over ``n`` ranks;
    ValueError unless n divides it (the reference's sharding cannot place
    such a cache either)."""
    if slots % n:
        raise ValueError(f"a decode cache of {slots} slots does not split "
                         f"over {n} ranks")
    return slots // n


def prefill(params: dict, tokens: torch.Tensor, cfg,
            max_seq: int) -> tuple:
    """Prompt forward tokens (B, S) building the decode cache. Returns
    (the last position's logits (B, V), cache) with ``pos`` = S."""
    b, s = tokens.shape
    cache = init_decode_cache(cfg, b, max_seq, getattr(torch, cfg.dtype),
                              tokens.device)
    x = embed_batch(params, tokens, cfg)
    caches = layer_views(cache["blocks"], cfg.n_layers)
    for lp, lc in zip(layer_views(params["blocks"], cfg.n_layers), caches):
        p = lp["l0"]
        x = x + attn.attn_prefill(p["attn"], norm_fwd(p["norm1"], x,
                                                      cfg.norm),
                                  lc["l0"], cfg)
        x = x + mlp_fwd(p["mlp"], norm_fwd(p["norm2"], x, cfg.norm), cfg)
    cache["pos"].fill_(s)
    x = norm_fwd(params["final_norm"], x[:, -1:], cfg.norm)
    return lm_head_fwd(params["embed"], x, cfg)[:, 0], cache


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                cfg, pal=None) -> tuple:
    """One token a sequence, token (B, 1) -> (logits (B, V), cache). The
    cache is updated in place (its k and v at the step's slot, ``pos`` +
    1) and returned. With ``pal.cache_seq_sharded`` the cache is this
    rank's slice of the sequence (``attention.attn_decode``)."""
    pos = cache["pos"]
    x = embed_batch(params, token, cfg, pos0=pos)
    caches = layer_views(cache["blocks"], cfg.n_layers)
    for lp, lc in zip(layer_views(params["blocks"], cfg.n_layers), caches):
        p = lp["l0"]
        x = x + attn.attn_decode(p["attn"], norm_fwd(p["norm1"], x,
                                                     cfg.norm),
                                 lc["l0"], pos, cfg, pal)
        x = x + mlp_fwd(p["mlp"], norm_fwd(p["norm2"], x, cfg.norm), cfg)
    pos.add_(1)
    x = norm_fwd(params["final_norm"], x, cfg.norm)
    return lm_head_fwd(params["embed"], x, cfg)[:, 0], cache
