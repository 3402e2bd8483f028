"""Decoder (and encoder-decoder) over heterogeneous layer stacks (the port
of ``repro.models.transformer`` for every family, dense, MoE, SSM,
hybrid, vision and audio, each under tensor and expert parallelism and,
in training, ring attention): attention, Mamba,
mLSTM or sLSTM mixers, dense, MoE or no FFN; training loss with the MoE
aux terms, prefill and cached decode.

Layers are grouped into super-blocks of period P (the reference's
``superblock_period``: xLSTM 2, Jamba 8, else 1): ``blocks/l{j}`` holds
the j-th layer of every super-block stacked along a leading axis (the
reference's ``jax.lax.scan`` stack), and a model with a dense prefix
(DeepSeek-V2's first layer) holds those layers, unstacked, in the list
``prefix``. Parameter tree, in the reference's layout so that the flat
vector of both packages lines up element for element::

    blocks/l{j}/{attn/{[bk,] wk, wo, [bq,] wq, [bv,] wv}
                  | attn/{dkv, kv_norm, uk, uv, wo, wq}
                  | mamba/{...} | mlstm/{...} | slstm/{...},
                 [cross/{[bk,] wk, wo, [bq,] wq, [bv,] wv},]
                 mlp/{down, gate, up} | mlp/{down, down_b, up, up_b}
                  | moe/{down, gate, router, [shared/{down, gate, up},] up},
                 [norm1/{[bias,] scale},] [norm2/{[bias,] scale},]
                 [norm_x/{[bias,] scale}]}
    embed/{[head,] tok}
    [encoder/{blocks/{attn, mlp, norm1, norm2}, final_norm}]
    final_norm/{[bias,] scale}
    [prefix/[i]/{attn, mlp, norm1, norm2}]

(bracketed leaves by layout: QKV bias, layernorm, untied embeddings,
shared experts, a dense prefix; ``norm1`` before attention and Mamba,
not before an mLSTM or sLSTM, which hold their own norm; ``norm2`` only
with an FFN; the mixers' leaves in ``models.mamba`` and
``models.xlstm``; ``cross`` and ``norm_x`` in an encoder-decoder's
decoder layers, ``encoder/blocks`` stacked over its layers). The forward
unbinds the stacked axis
once, so each stacked leaf's gradient is assembled by one ``stack``
rather than one full-size scatter per layer, and recomputes each layer
in the backward pass (``torch.utils.checkpoint``) when ``cfg.remat``.
The loss adds (load_balance_loss * lb_loss + router_z_loss * z_loss) /
(MoE layers), each aux term summed over the MoE layers, as the
reference's.

The decode cache keeps the reference's tree too, ``{pos, blocks/l{j}/{k,
v} | {ckv, krope} | {conv, h} | {c, n, m}[, prefix/[i]/...][, cross/{k,
v}]}`` (by the layer's mixer) with the super-block axis leading on the
stacked leaves, so a cache crosses between the packages
(``convert.cache_from_jax``). ``pos`` is a 0-d int32 tensor on the
device: decode reads it there, and no step waits on the host. A model
with an SSM adds no sinusoidal positions (the reference's rule: its
recurrence carries the order).

The two frontend stubs (the reference's): a vision model's batch carries
``patches`` (B, P, d), which OVERWRITE the token embeddings of positions
< P (cast to the model's dtype; the reference's docstrings say
"prepended", its code overwrites); an audio model's carries ``frames``
(B, S_enc, d), which the encoder (sinusoidal positions, bidirectional
attention and dense layers, its own final norm) turns into ``enc_out``.
Every decoder layer of an encoder-decoder then runs cross-attention
(``norm_x``, ``cross``) between its mixer and its FFN: in training over
its own projection of ``enc_out``, so the encoder's gradient arrives
through cross-attention only; prefill projects it once a layer, attends
with the projection and stores it, cast to the cache's dtype, in the
top-level ``cross`` leaf ``{k, v}``, each (super-blocks, B, S_enc, KV,
hd), which decode reads.

Tensor parallelism (a ``Parallel`` with a model group, threaded through
every function as ``pal``; None is one rank): each rank holds its share
of the parameters (``models.specs``), attention by heads (MLA's too),
the MLP by hidden units, the MoE by experts, Mamba and the sLSTM by
channels, the mLSTM by each head's value dims, the embedding and head
by vocabulary; the recurrent layers' decode state is the rank's share.
In training the residual stream is split by sequence when
``pal.seq_parallel`` (Megatron-SP, as the reference's train step runs):
the whole sequence is embedded and psum-scattered to the rank's chunk,
each mixer and MLP gathers and scatters inside, and the final hidden
state is gathered for the loss. The loss is vocabulary-parallel; every
rank computes it at every position (the head's psums need all ranks at
the same positions) but sums only its own chunk of the sequence over the
global count of targets, so the ranks' losses are disjoint shares whose
sum (:func:`global_loss`) is the loss; an MoE model's aux term is
divided by tp, and its aux metrics are the model group's means. Prefill
and decode run without the sequence split and gather the vocabulary's
logits (B, V padded to a multiple of tp).

The two stubs under tensor parallelism keep the reference's layout: the
patches overwrite the positions < P of the rank's sequence chunk (its
global positions r S/tp + i), and the encoder takes the whole frames on
every rank. Under the sequence split each encoder layer then gathers tp
copies of the frames' sequence for attention and the MLP and
psum-scatters back (the reference passes the whole frames into layers
that run split; the copies change only the rounding), and each decoder
layer's cross-attention gathers the decoder's sequence for its queries
over the rank's heads of the encoder's output. Ring attention
(``Parallel(attn_dist="ring")``, training only) gives every rank all the
heads of its own attention weights (``init_rank_params`` draws them per
model rank) and runs ``attention.ring_fwd`` in the decoder's and the
encoder's self-attention; the encoder's ring sees the rank's whole
frames as its block, at positions r S_enc + i.
"""
from __future__ import annotations

import itertools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ffn_pattern, layer_pattern
from repro_torch.core.flatten import tree_from_items, tree_items
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (
    embed_fwd, init_embed, init_mlp, init_norm, lm_head_fwd, mlp_fwd,
    norm_fwd, sharded_xent,
)
from repro_torch.models.parallel import (
    all_gather_model, axis_index, pmean_model, psum_model, shard_slice,
)

LOSS_CHUNK = 512
AUX_KEYS = ("lb_loss", "z_loss", "drop_frac")


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
ATTN_KINDS = ("full", "sliding", "mla")
MIXERS = ("attn", "mamba", "mlstm", "slstm")


def superblock_period(cfg) -> int:
    return ffn_pattern(cfg)[0]


def n_superblocks(cfg) -> int:
    p = superblock_period(cfg)
    body = cfg.n_layers - cfg.n_dense_prefix
    if body % p:
        raise ValueError(f"{cfg.name}: {body} layers past the prefix do "
                         f"not split into super-blocks of {p}")
    return body // p


def n_moe_layers(cfg) -> int:
    return n_superblocks(cfg) * sum(f == "moe" for _, f in layer_pattern(cfg))


def check_model(cfg) -> None:
    """Raise ValueError for a family, attention kind or mixer the
    reference does not have, a causal encoder (the reference's encoder is
    bidirectional whatever ``enc_causal`` says), or an encoder-decoder
    whose cross cache (one layer a super-block, the reference's layout)
    cannot hold its layers."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} "
                         f"(expected one of {FAMILIES})")
    if cfg.attn_kind not in ATTN_KINDS:
        raise ValueError(f"{cfg.name}: unknown attn_kind {cfg.attn_kind!r} "
                         f"(expected one of {ATTN_KINDS})")
    for mixer, _ in layer_pattern(cfg):
        if mixer not in MIXERS:
            raise ValueError(f"{cfg.name}: unknown mixer {mixer!r} "
                             f"(expected one of {MIXERS})")
    if cfg.enc_causal:
        raise ValueError(f"{cfg.name}: enc_causal=True: the encoder is "
                         "bidirectional, as the reference's")
    if not cfg.is_encoder_decoder:
        return
    if cfg.n_dense_prefix or len(layer_pattern(cfg)) > 1:
        raise ValueError(f"{cfg.name}: an encoder-decoder's cross cache "
                         "holds one layer a super-block and no dense "
                         "prefix")


def _init_layer(gen, cfg, mixer: str, ffn: str, lead=(), device=None,
                cross: bool = False, pal=None) -> dict:
    p = {}
    if mixer in ("attn", "mamba"):
        p["norm1"] = init_norm(cfg, lead=lead, device=device)
    if mixer == "attn":
        p["attn"] = attn.init_attention(gen, cfg, lead=lead, device=device,
                                        pal=pal)
    elif mixer == "mamba":
        p["mamba"] = mam.init_mamba(gen, cfg, lead=lead, device=device,
                                    pal=pal)
    elif mixer == "mlstm":
        p["mlstm"] = xl.init_mlstm(gen, cfg, lead=lead, device=device,
                                   pal=pal)
    else:
        p["slstm"] = xl.init_slstm(gen, cfg, lead=lead, device=device,
                                   pal=pal)
    if cross:
        p["norm_x"] = init_norm(cfg, lead=lead, device=device)
        p["cross"] = attn.init_attention(gen, cfg, lead=lead, device=device,
                                         cross=True, pal=pal)
    if ffn != "none":
        p["norm2"] = init_norm(cfg, lead=lead, device=device)
    if ffn == "dense":
        p["mlp"] = init_mlp(gen, cfg, lead=lead, device=device, pal=pal)
    elif ffn == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, lead=lead, device=device,
                                    pal=pal)
    return p


def init_params(cfg, gen: torch.Generator, device=None, pal=None) -> dict:
    """Random fp32 parameters drawn from ``gen`` (on ``device``): the
    super-blocks' layers, the embedding, the final norm, the prefix, the
    encoder; under tensor parallelism this rank's share of each leaf
    (``models.specs``), all drawn from ``gen``."""
    check_model(cfg)
    lead = (n_superblocks(cfg),)
    pattern = layer_pattern(cfg)
    cross = cfg.is_encoder_decoder
    blocks = {f"l{j}": _init_layer(gen, cfg, mixer, ffn, lead, device,
                                   cross, pal)
              for j, (mixer, ffn) in enumerate(pattern)}
    params = {"embed": init_embed(gen, cfg, device=device, pal=pal),
              "blocks": blocks,
              "final_norm": init_norm(cfg, device=device)}
    if cfg.n_dense_prefix:
        params["prefix"] = [_init_layer(gen, cfg, pattern[0][0], "dense",
                                        device=device, pal=pal)
                            for _ in range(cfg.n_dense_prefix)]
    if cross:
        params["encoder"] = {
            "blocks": _init_layer(gen, cfg, "attn", "dense",
                                  (cfg.n_enc_layers,), device, pal=pal),
            "final_norm": init_norm(cfg, device=device)}
    return params


def rank_seed(seed: int, pal=None) -> int:
    """The seed of this rank's parameter draw: ``seed`` on model rank 0
    (and at tp 1), another stream on each other model rank."""
    return seed + 65537 * axis_index(pal)


def init_rank_params(cfg, seed: int, device=None, pal=None) -> dict:
    """This rank's parameters from ``seed``: :func:`init_params` from a
    generator at :func:`rank_seed`, so the split leaves are drawn per
    model rank, then the replicated leaves (``models.specs``) broadcast
    from model rank 0, so every model rank holds their bits (the
    reference draws twice and selects). Under ring attention the
    attention leaves hold all the heads, still drawn per model rank, as
    the reference draws them (its specs keep them split). At tp 1
    ``init_params`` from ``seed``."""
    from repro_torch.models.parallel import broadcast_model
    from repro_torch.models.specs import leaf_dim
    gen = torch.Generator(device=device).manual_seed(rank_seed(seed, pal))
    params = init_params(cfg, gen, device, pal)
    if pal is not None and pal.tp_on:
        for path, leaf in tree_items(params):
            if leaf_dim(path, leaf.ndim) is None:
                broadcast_model(leaf, pal)
    return params


def _ffn(p: dict, x: torch.Tensor, cfg, ffn: str, aux=None, pal=None):
    """The layer's FFN half on the residual x: (x, aux + the MoE's)."""
    if ffn == "dense":
        x = x + mlp_fwd(p["mlp"], norm_fwd(p["norm2"], x, cfg.norm), cfg,
                        pal)
    elif ffn == "moe":
        y, a = moe_mod.moe_fwd(p["moe"], norm_fwd(p["norm2"], x, cfg.norm),
                               cfg, pal)
        x = x + y
        if aux is not None:
            aux = tuple(s + a[key] for s, key in zip(aux, AUX_KEYS))
    return x, aux


def _mixer(p: dict, x: torch.Tensor, cfg, mixer: str,
           cache: dict = None, causal: bool = True,
           pal=None) -> torch.Tensor:
    """The layer's mixer half on the residual x (norm1 first for
    attention and Mamba; attention bidirectional in an encoder, not
    ``causal``). With ``cache`` (one layer's views of a decode cache) a
    prefill: attention writes the prompt's k and v, a recurrent mixer
    its final state."""
    if mixer == "attn":
        h = norm_fwd(p["norm1"], x, cfg.norm)
        y = attn.attn_fwd_full(p["attn"], h, cfg, causal, pal) \
            if cache is None else attn.attn_prefill(p["attn"], h, cache, cfg,
                                                    pal)
    elif mixer == "mamba":
        y = mam.mamba_fwd(p["mamba"], norm_fwd(p["norm1"], x, cfg.norm), cfg,
                          cache, pal)
    elif mixer == "mlstm":
        y = xl.mlstm_fwd(p["mlstm"], x, cfg, cache, pal)
    else:
        y = xl.slstm_fwd(p["slstm"], x, cfg, cache, pal)
    return x + y


def _mixer_decode(p: dict, x: torch.Tensor, cache: dict, pos, cfg,
                  mixer: str, pal) -> torch.Tensor:
    """One token through the layer's mixer half, its cache updated in
    place."""
    if mixer == "attn":
        y = attn.attn_decode(p["attn"], norm_fwd(p["norm1"], x, cfg.norm),
                             cache, pos, cfg, pal)
    elif mixer == "mamba":
        y = mam.mamba_decode(p["mamba"], norm_fwd(p["norm1"], x, cfg.norm),
                             cache, cfg, pal)
    elif mixer == "mlstm":
        y = xl.mlstm_decode(p["mlstm"], x, cache, cfg, pal)
    else:
        y = xl.slstm_decode(p["slstm"], x, cache, cfg, pal)
    return x + y


def _cross(p: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg, pal=None) -> torch.Tensor:
    """The decoder layer's cross-attention on the residual x, over the
    encoder's k and v (B, S_enc, KV, hd; this rank's heads under tensor
    parallelism)."""
    return x + attn.cross_attention(p["cross"], norm_fwd(p["norm_x"], x,
                                                         cfg.norm), k, v, cfg,
                                    pal)


def _layer_fwd(p: dict, x: torch.Tensor, cfg, mixer: str, ffn: str,
               enc_out, pal, *aux):
    x = _mixer(p, x, cfg, mixer, pal=pal)
    if enc_out is not None:
        x = _cross(p, x, *attn.cross_kv(p["cross"], enc_out, cfg), cfg, pal)
    x, aux = _ffn(p, x, cfg, ffn, aux, pal)
    return (x, *aux)


def _enc_layer(p: dict, x: torch.Tensor, cfg, pal=None) -> torch.Tensor:
    return _ffn(p, _mixer(p, x, cfg, "attn", causal=False, pal=pal), cfg,
                "dense", pal=pal)[0]


def layer_views(blocks: dict, n_layers: int) -> list:
    """Per-super-block trees of views into the stacked leaves (parameters
    or a decode cache's)."""
    unbound = [(path, leaf.unbind(0)) for path, leaf in tree_items(blocks)]
    return [tree_from_items((path, views[i]) for path, views in unbound)
            for i in range(n_layers)]


def layers(params: dict, cfg) -> list:
    """[(layer parameters, mixer, ffn kind)] in forward order: the
    prefix (the pattern's first mixer, a dense FFN), then each
    super-block's layers."""
    pattern = layer_pattern(cfg)
    out = [(p, pattern[0][0], "dense") for p in params.get("prefix", [])]
    for sb in layer_views(params["blocks"], n_superblocks(cfg)):
        out.extend((sb[f"l{j}"], mixer, ffn)
                   for j, (mixer, ffn) in enumerate(pattern))
    return out


def layer_caches(cache: dict, cfg) -> list:
    """Per-layer views of a decode cache, in :func:`layers`'s order."""
    out = list(cache.get("prefix", []))
    n = len(layer_pattern(cfg))
    for sb in layer_views(cache["blocks"], n_superblocks(cfg)):
        out.extend(sb[f"l{j}"] for j in range(n))
    return out


def forward_hidden(params: dict, x: torch.Tensor, cfg,
                   with_aux: bool = False, enc_out: torch.Tensor = None,
                   pal=None):
    """The layer stack and the final norm on embedded x (with ``enc_out``,
    the encoder's output, each layer's cross-attention over it); with
    ``with_aux`` (x, {lb_loss, z_loss, drop_frac}), each summed over the
    MoE layers (0 without any). Under sequence parallelism x is this
    rank's chunk of the sequence, and so is the result."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = tuple(torch.zeros((), dtype=torch.float32, device=x.device)
                for _ in AUX_KEYS)
    for p, mixer, ffn in layers(params, cfg):
        if remat:
            x, *aux = checkpoint(_layer_fwd, p, x, cfg, mixer, ffn, enc_out,
                                 pal, *aux, use_reentrant=False)
        else:
            x, *aux = _layer_fwd(p, x, cfg, mixer, ffn, enc_out, pal, *aux)
    x = norm_fwd(params["final_norm"], x, cfg.norm)
    return (x, dict(zip(AUX_KEYS, aux))) if with_aux else x


def encode(params: dict, frames: torch.Tensor, cfg, pal=None) -> torch.Tensor:
    """The encoder over frame embeddings (B, S_enc, d) in their dtype:
    sinusoidal positions added, ``n_enc_layers`` bidirectional attention
    and dense layers (each recomputed in the backward pass when
    ``cfg.remat``), the encoder's final norm. Under tensor parallelism
    every rank takes the whole frames, and its layers run as the
    decoder's do (module docstring: tp copies of the sequence gathered
    under the sequence split; ring attention over blocks of S_enc)."""
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames + sinusoidal(pos, cfg.d_model).to(frames.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    enc = params["encoder"]
    for p in layer_views(enc["blocks"], cfg.n_enc_layers):
        x = checkpoint(_enc_layer, p, x, cfg, pal, use_reentrant=False) \
            if remat else _enc_layer(p, x, cfg, pal)
    return norm_fwd(enc["final_norm"], x, cfg.norm)


def sinusoidal(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(len(pos), d) fp32 absolute positions: sin at even dims, cos at odd
    ones, of pos / 10000^(2i/d) (the reference's ``_sinusoidal``), the
    division spelled as the compiled reference's multiply by the fp32
    reciprocal (bitwise with its full-sequence table; at position 1500 a
    true division moves an angle by an ulp of 1.2e-4)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[:, None] * (1.0 / torch.pow(torch.tensor(
        10000.0, device=pos.device), dim / d))
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(
        pos.shape[0], d)


def embed_batch(params: dict, tokens: torch.Tensor, cfg, pos0=None,
                patches: torch.Tensor = None, pal=None) -> torch.Tensor:
    """tokens (B, S) -> x (B, S, d) in the model's dtype, positions < P
    overwritten by ``patches`` (B, P, d) cast to it, with the sinusoidal
    positions added when the model has neither RoPE nor an SSM. ``pos0``
    (a 0-d device tensor) is the first token's position, 0 by default.
    With ``pal.sp`` the whole sequence is embedded and psum-scattered:
    x is this rank's chunk (B, S/tp, d) (the reference embeds first, as
    every model rank must look up the same tokens), and the patches and
    positions are those of its global positions r S/tp + i."""
    sp = pal is not None and pal.sp
    x = embed_fwd(params["embed"], tokens, cfg, pal,
                  "scatter" if sp else "psum")
    pos = torch.arange(x.shape[1], device=tokens.device)
    if sp:
        pos = pos + axis_index(pal) * x.shape[1]
    if patches is not None:
        npat = patches.shape[1]
        over = patches.index_select(1, pos.clamp(max=npat - 1))
        x = torch.where((pos < npat)[None, :, None], over.to(x.dtype), x)
    if not cfg.rope and cfg.ssm is None:
        if pos0 is not None:
            pos = pos + pos0
        x = x + sinusoidal(pos, cfg.d_model).to(x.dtype)
    return x


def chunked_xent(params: dict, x: torch.Tensor, targets: torch.Tensor,
                 cfg, pal=None) -> torch.Tensor:
    """Mean next-token cross-entropy over targets >= 0, chunked over seq.
    Under tensor parallelism x is the whole sequence on every rank, the
    logits vocabulary-parallel, and each rank sums only its own chunk of
    the sequence, over the count of targets summed over the model group
    outside autograd: the ranks' results are disjoint shares of the loss
    (:func:`global_loss`). Seeding each rank's backward pass with its own
    share, the collectives' transposes deliver the other terms; seeding it
    with the summed loss would count every gradient tp times."""
    s = x.shape[1]
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        chunk = s
    tp_on = pal is not None and pal.tp_on
    if tp_on:
        sl = shard_slice(s, pal)
        own = (torch.arange(s, device=x.device) // sl) == axis_index(pal)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for off in range(0, s, chunk):
        tc = targets[:, off:off + chunk]
        logits = lm_head_fwd(params["embed"], x[:, off:off + chunk], cfg, pal)
        valid = (tc >= 0).float()
        if tp_on:
            valid = valid * own[off:off + chunk]
        nll = sharded_xent(logits, tc.clamp(min=0), pal)
        tot = tot + (nll * valid).sum()
        cnt = cnt + valid.sum()
    if tp_on:
        cnt = psum_model(cnt.detach(), pal)
    return tot / cnt.clamp(min=1.0)


def global_loss(loss: torch.Tensor, pal=None) -> torch.Tensor:
    """The loss from the ranks' disjoint shares: their sum over the model
    group, outside autograd (metrics only)."""
    return psum_model(loss.detach(), pal)


def _patches(batch: dict, cfg):
    """The batch's patches where the model has the vision stub."""
    return batch.get("patches") if cfg.frontend == "vision_stub" else None


def _encoded(params: dict, batch: dict, cfg, pal=None):
    """The encoder's output over the batch's frames (cast to the model's
    dtype), for an encoder-decoder; else None."""
    if not cfg.is_encoder_decoder:
        return None
    return encode(params, batch["frames"].to(getattr(torch, cfg.dtype)), cfg,
                  pal)


def hidden(params: dict, batch: dict, cfg, with_aux: bool = False,
           pal=None):
    """:func:`forward_hidden` of a batch: its tokens embedded with its
    patches, over its frames' encoding (this rank's sequence chunk under
    sequence parallelism)."""
    x = embed_batch(params, batch["tokens"], cfg,
                    patches=_patches(batch, cfg), pal=pal)
    return forward_hidden(params, x, cfg, with_aux,
                          _encoded(params, batch, cfg, pal), pal)


def loss_and_aux(params: dict, batch: dict, cfg, pal=None) -> tuple:
    """(loss, {lb_loss, z_loss, drop_frac}): the mean next-token
    cross-entropy plus, for an MoE model, its aux term. batch: tokens
    (B, S) int64; targets (B, S) int64, -1 = masked; a vision model's
    patches, an audio model's frames (B, P or S_enc, d). Under tensor
    parallelism the loss is this rank's share (:func:`chunked_xent`), the
    aux term, from the rank's own tokens, divided by tp, and the aux
    metrics the model group's means."""
    check_model(cfg)
    x, aux = hidden(params, batch, cfg, with_aux=True, pal=pal)
    if pal is not None and pal.sp:
        x = all_gather_model(x, pal, 1)
    loss = chunked_xent(params, x, batch["targets"], cfg, pal)
    if cfg.moe is not None:
        m = cfg.moe
        term = (m.load_balance_loss * aux["lb_loss"]
                + m.router_z_loss * aux["z_loss"]) / max(n_moe_layers(cfg), 1)
        if pal is not None and pal.tp_on:
            term = term / pal.tp
            aux = {key: pmean_model(val, pal) for key, val in aux.items()}
        loss = loss + term
    return loss, aux


def loss_fn(params: dict, batch: dict, cfg, pal=None) -> torch.Tensor:
    """The loss of :func:`loss_and_aux`."""
    return loss_and_aux(params, batch, cfg, pal)[0]


def gather_vocab(logits: torch.Tensor, pal=None) -> torch.Tensor:
    """The model group's vocabulary columns of (..., V/tp) logits, in
    rank order: (..., V padded)."""
    return all_gather_model(logits, pal, logits.ndim - 1)


def full_logits(params: dict, batch: dict, cfg, pal=None) -> torch.Tensor:
    """Logits (B, S, V) of the whole sequence of a batch (tokens, and
    patches or frames), no cache: what prefill and decode are held
    against (under tensor parallelism the padded vocabulary's, gathered
    over the model group; no sequence split)."""
    check_model(cfg)
    if pal is not None and pal.sp:
        raise ValueError("full_logits runs without the sequence split")
    return gather_vocab(lm_head_fwd(params["embed"],
                                    hidden(params, batch, cfg, pal=pal), cfg,
                                    pal), pal)


# ---------------------------------------------------------------------------
# Serving: prefill + decode (call under torch.inference_mode)
# ---------------------------------------------------------------------------

def _layer_cache(cfg, mixer: str, batch: int, slots: int, dtype,
                 lead=(), device=None, pal=None) -> dict:
    if mixer == "attn":
        return attn.init_cache(cfg, batch, slots, dtype, lead=lead,
                               device=device, pal=pal)
    if mixer == "mamba":
        return mam.init_mamba_cache(cfg, batch, dtype, lead=lead,
                                    device=device, pal=pal)
    if mixer == "mlstm":
        return xl.init_mlstm_cache(cfg, batch, lead=lead, device=device,
                                   pal=pal)
    return xl.init_slstm_cache(cfg, batch, lead=lead, device=device,
                               pal=pal)


def init_decode_cache(cfg, batch: int, max_seq: int, dtype,
                      device=None, pal=None, enc_seq: int = 0) -> dict:
    """Zero cache tree for ``batch`` sequences of up to ``max_seq``
    positions, each layer's by its mixer: attention's k and v (a sliding
    model keeps min(window, max_seq) slots), a recurrent mixer's state,
    and an encoder-decoder's cross k and v over ``enc_seq`` positions;
    with ``pal.cache_seq_sharded`` this rank's slice of the slots of
    every attention layer (MLA's ckv and krope too), which must split
    evenly over the group, and the whole of every recurrent state and of
    the cross k and v (the reference replicates them over the data
    ranks, and every rank steps the whole batch's state); under
    tensor parallelism this rank's key/value heads and share of each
    recurrent state (MLA's ckv and krope whole), and its key/value heads
    of the cross k and v."""
    check_model(cfg)
    slots = attn.cache_max_seq(cfg, max_seq)
    if pal is not None and pal.cache_seq_sharded:
        slots = cache_slice_len(slots, pal.size)
    lead = (n_superblocks(cfg),)
    pattern = layer_pattern(cfg)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device),
             "blocks": {f"l{j}": _layer_cache(cfg, mixer, batch, slots,
                                              dtype, lead, device, pal)
                        for j, (mixer, _) in enumerate(pattern)}}
    if cfg.n_dense_prefix:
        cache["prefix"] = [_layer_cache(cfg, pattern[0][0], batch, slots,
                                        dtype, device=device, pal=pal)
                           for _ in range(cfg.n_dense_prefix)]
    if cfg.is_encoder_decoder:
        shape = (*lead, batch, enc_seq, attn.head_counts(cfg, pal)[1],
                 cfg.resolved_head_dim)
        cache["cross"] = {name: torch.zeros(shape, dtype=dtype,
                                            device=device)
                          for name in ("k", "v")}
    return cache


def _cross_caches(cache: dict):
    """Per-layer (k, v) views of the cache's ``cross`` leaf (one layer a
    super-block), or None for every layer of a model without one."""
    if "cross" not in cache:
        return itertools.repeat(None)
    return zip(cache["cross"]["k"].unbind(0), cache["cross"]["v"].unbind(0))


def cache_slice_len(slots: int, n: int) -> int:
    """One rank's slots of a cache of ``slots`` split over ``n`` ranks;
    ValueError unless n divides it (the reference's sharding cannot place
    such a cache either)."""
    if slots % n:
        raise ValueError(f"a decode cache of {slots} slots does not split "
                         f"over {n} ranks")
    return slots // n


def prefill(params: dict, batch: dict, cfg, max_seq: int,
            pal=None) -> tuple:
    """Prompt forward of a batch (tokens (B, S), and patches or frames)
    building the decode cache. Returns (the last position's logits (B,
    V), cache) with ``pos`` = S; an encoder-decoder's cache holds every
    layer's cross k and v. Under tensor parallelism the cache holds this
    rank's heads and share of each recurrent state, and the logits are
    the padded vocabulary's, gathered."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    enc_out = _encoded(params, batch, cfg, pal)
    cache = init_decode_cache(
        cfg, b, max_seq, getattr(torch, cfg.dtype), tokens.device, pal,
        enc_seq=0 if enc_out is None else enc_out.shape[1])
    x = embed_batch(params, tokens, cfg, patches=_patches(batch, cfg),
                    pal=pal)
    for (p, mixer, ffn), lc, xc in zip(layers(params, cfg),
                                       layer_caches(cache, cfg),
                                       _cross_caches(cache)):
        x = _mixer(p, x, cfg, mixer, lc, pal=pal)
        if xc is not None:
            k, v = attn.cross_kv(p["cross"], enc_out, cfg)
            xc[0].copy_(k)
            xc[1].copy_(v)
            x = _cross(p, x, k, v, cfg, pal)
        x = _ffn(p, x, cfg, ffn, pal=pal)[0]
    cache["pos"].fill_(s)
    x = norm_fwd(params["final_norm"], x[:, -1:], cfg.norm)
    return gather_vocab(lm_head_fwd(params["embed"], x, cfg, pal),
                        pal)[:, 0], cache


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                cfg, pal=None) -> tuple:
    """One token a sequence, token (B, 1) -> (logits (B, V), cache). The
    cache is updated in place (the step's slot of every attention layer,
    every recurrent layer's state, ``pos`` + 1) and returned. With
    ``pal.cache_seq_sharded`` the cache is this rank's slice of the
    sequence (``attention.attn_decode``); under tensor parallelism the
    logits are the padded vocabulary's, gathered over the model group."""
    pos = cache["pos"]
    x = embed_batch(params, token, cfg, pos0=pos, pal=pal)
    for (p, mixer, ffn), lc, xc in zip(layers(params, cfg),
                                       layer_caches(cache, cfg),
                                       _cross_caches(cache)):
        x = _mixer_decode(p, x, lc, pos, cfg, mixer, pal)
        if xc is not None:
            x = _cross(p, x, *xc, cfg, pal)
        x = _ffn(p, x, cfg, ffn, pal=pal)[0]
    pos.add_(1)
    x = norm_fwd(params["final_norm"], x, cfg.norm)
    return gather_vocab(lm_head_fwd(params["embed"], x, cfg, pal),
                        pal)[:, 0], cache
