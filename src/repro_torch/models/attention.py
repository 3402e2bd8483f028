"""Self-attention: GQA with optional QKV bias, partial RoPE or none,
causal (full or sliding-window) or bidirectional (an encoder's), and MLA
(DeepSeek-V2's multi-head latent attention, expanded or absorbed), with
their caches, and an encoder-decoder's cross-attention (the port of the
full-sequence, prefill and decode paths of ``repro.models.attention``,
with context-parallel decode of GQA, tensor parallelism by heads of
self- and cross-attention, and ring attention).

The reference has no Pallas kernel here: its attention is plain jnp. The
port keeps it plain PyTorch too: a matmul, a mask and an fp32 softmax.
It does not call ``scaled_dot_product_attention``. The full-sequence
path is the reference's ``_sdpa_chunked`` at every length: queries in
chunks of ``Q_CHUNK`` against keys in chunks of ``KV_CHUNK`` with an
online softmax, normalised after the value product, the last chunk of
each short where the length is not a multiple. (At such a length the
reference takes one softmax normalised before the value product,
``_sdpa``; the two forms agree to a few fp32 ulps, and the tests hold
them to rtol 1e-5.) Key chunks wholly above the causal diagonal are
skipped: their weights are exactly 0 after the merge. Bidirectional
attention (``full_attention``: the encoder's, and cross-attention's)
is the same loop over every key chunk, unmasked.

Cross-attention (the reference's ``cross_kv`` branches): each decoder
layer's ``cross`` parameters are the plain ``{wk, wo, wq, wv[, bk, bq,
bv]}`` whatever the model's attention kind; ``cross_kv`` projects the
encoder's output (B, S_enc, d) to k and v with the layer's own weights,
and ``cross_attention`` attends the layer's queries, without RoPE or a
mask, over all S_enc of them: in training and prefill over the
projection itself, in decode over the cache's ``cross`` copy.

The cache of a layer is ``{k, v}``, each (B, S_cache, KV, hd) in the
model's dtype. Decode writes the step's k and v into it in place (the
caller holds ``torch.inference_mode``); a sliding window keeps a ring
buffer of min(window, cache length) slots, position p at slot p % cap.

MLA projects each token to a compressed ``ckv`` (kv_lora_rank, rmsnormed)
and one shared RoPE key ``krope`` (rope_head_dim); the queries carry
head_dim + rope_head_dim dims a head, the RoPE part rotated. The expanded
form builds each head's k (head_dim + rope_head_dim) and v (v_head_dim)
from ``ckv`` and attends as above (k and v of unequal widths); the
absorbed form (``cfg.mla_absorb``) projects the queries through the key
up-projection and attends over ``ckv`` itself, applying the value
up-projection to the context. The scale is head_dim ** -0.5 in both. The
cache of an MLA layer is ``{ckv, krope}``. An MLA encoder-decoder's
encoder attends bidirectionally in either form (every key chunk,
unmasked), on one rank, split by heads and under ring attention; its
cross-attention stays the plain kind.

Tensor parallelism (a ``Parallel`` with a model group of tp ranks)
splits attention by heads, the reference's ``attn_dist="sp"``: the query
and key/value head counts are padded to multiples of tp, rank r holds
heads [r H/tp, (r + 1) H/tp) of wq, wk, wv (and their biases) and the
matching rows of wo, GQA groups within the rank, and the output of a
padded head (global index >= n_heads) is zeroed before wo (padded heads
are drawn like the others, not zero-initialised: the reference's
``mask_padded_heads``). wo's output is summed over the model group, or,
with the residual stream split by sequence, the layer gathers the
sequence first and psum-scatters wo's output back. The decode cache
holds the rank's key/value heads. MLA splits the same way by query
head: wq (q_lora_rank is 0: the queries are projected directly), uk
and uv by column, wo by row, its padded heads masked; ``dkv`` and
``kv_norm`` are replicated, so every rank computes the whole ckv and
krope, and its cache, which has no head axis, is whole on every rank.
The expanded form expands the rank's heads; the absorbed form absorbs
the rank's heads of uk and uv. Cross-attention splits by heads too: the
rank's heads of its q, k and v, wo's output summed (or psum-scattered)
over the model group, the decode cache's ``cross`` copy the rank's
key/value heads.

Ring attention (``attn_dist="ring"``, the reference's ``_ring_fwd``,
training only): every rank holds all the heads (``head_counts``; no
padding, nothing masked), in weights of its own (the split leaves are
drawn per model rank), and its block of the sequence, at global
positions r S_local + i. Its queries attend to the tp key/value blocks in
turn: its own, then each block the previous rank passes on
(``ppermute_model``), which that rank projected with its own weights;
MLA passes the compressed (ckv, krope) and expands it with the local uk
and uv at every hop (never absorbed). The blocks merge with the online
softmax on global positions (causal, sliding or, in an encoder,
bidirectional), and wo's output stays the rank's block, not summed. So
a ring model is not a one-card model, and the port reproduces it device
by device. Cross-attention under ring keeps its branch: every rank's
cross weights have all the heads, and the psum-scatter of wo's output
sums the ranks' full-head outputs (the reference's, kept).

Context-parallel decode (a ``Parallel`` with ``cache_seq_sharded``, the
reference's ``cache_seq_axis``): rank r holds slots [r sl, (r + 1) sl)
of a cache of sl * n slots (MLA's ckv and krope too). Decode writes the
step's cache entries only on the rank that owns the slot, masks by
global slot positions (a sliding ring's cap is sl * n), and merges the
ranks' partial outputs: the MAX all-reduce of the running max, then the
rank-order sums of the output and of the softmax sum, each scaled by
exp(m - max) (the reference's ``_decode_attend``). Expanded MLA expands
the rank's slice and merges the same way; absorbed MLA merges its
unnormalised context over ckv, then divides by the summed softmax sum
and applies the value up-projection (the reference's
``_decode_attend_absorbed``), not the one-rank path's softmax.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init, norm_fwd
from repro_torch.models.parallel import (
    all_gather_model, all_reduce_max, all_reduce_sum, axis_index,
    heads_padded, ppermute_model, psum_model, psum_scatter_model, ring_on,
    row_parallel_out, seq_gathered, shard_slice,
)

NEG_INF = -1e30
Q_CHUNK = 1024
KV_CHUNK = 2048


def rope_angles(pos: torch.Tensor, rot_dim: int,
                theta: float) -> torch.Tensor:
    """(S, rot_dim/2) fp32 rotation angles pos * theta^(-2i/rot_dim)."""
    ar = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=pos.device)
    return pos[:, None].float() * theta ** (-ar / rot_dim)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, rot_dim: int,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd), pos (S,). Rotates the INTERLEAVED pairs
    (x[..., 0::2], x[..., 1::2]) of the first rot_dim dims (not the
    rotate-half layout)."""
    if rot_dim == 0:
        return x
    angle = rope_angles(pos, rot_dim, theta)
    cos = torch.cos(angle)[None, :, None, :]
    sin = torch.sin(angle)[None, :, None, :]
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    rot = rot.reshape(xr.shape)
    return torch.cat([rot.to(x.dtype), x[..., rot_dim:]], -1)


def head_counts(cfg, pal=None) -> tuple:
    """(query heads, key/value heads) of this rank: the config's at tp 1
    and under ring attention (every rank all of them), else each padded
    to a multiple of tp and split over the model group."""
    if pal is None or not pal.tp_on or ring_on(pal):
        return cfg.n_heads, cfg.n_kv_heads
    hp, kvp = heads_padded(cfg.n_heads, pal), heads_padded(cfg.n_kv_heads,
                                                          pal)
    if hp % kvp:
        raise ValueError(f"{cfg.name}: {hp} padded query heads do not group "
                         f"over {kvp} padded key/value heads")
    return shard_slice(hp, pal), shard_slice(kvp, pal)


def mask_padded_heads(o: torch.Tensor, cfg, pal=None) -> torch.Tensor:
    """Zero the outputs (B, S, Hl, hd) of the padded heads (global index
    >= n_heads), so padding is neutral (the reference's
    ``mask_padded_heads``); nothing under ring attention, which pads no
    head."""
    if pal is None or not pal.tp_on or ring_on(pal):
        return o
    hl = o.shape[2]
    if hl * pal.tp <= cfg.n_heads:
        return o
    gh = axis_index(pal) * hl + torch.arange(hl, device=o.device)
    return o * (gh < cfg.n_heads)[None, None, :, None].to(o.dtype)


def init_attention(gen, cfg, *, lead=(), device=None,
                   cross: bool = False, pal=None) -> dict:
    """{wk, wo, wq, wv}, and with ``qkv_bias`` the zero biases {bk, bq,
    bv}; for MLA {dkv, kv_norm, uk, uv, wo, wq}, unless ``cross``
    (cross-attention's weights are the plain ones for every kind). Under
    tensor parallelism this rank's heads (all of them under ring
    attention)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = head_counts(cfg, pal)
    if cfg.attn_kind == "mla" and not cross:
        lora, rhd = cfg.kv_lora_rank, cfg.rope_head_dim
        vhd = cfg.v_head_dim or hd
        return {"dkv": dense_init(gen, d, lora + rhd, lead=lead,
                                  device=device),
                "kv_norm": torch.ones((*lead, lora), device=device),
                "uk": dense_init(gen, lora, h * hd, lead=lead, device=device),
                "uv": dense_init(gen, lora, h * vhd, lead=lead,
                                 device=device),
                "wq": dense_init(gen, d, h * (hd + rhd), lead=lead,
                                 device=device),
                "wo": dense_init(gen, h * vhd, d, lead=lead, device=device)}
    p = {"wk": dense_init(gen, d, kv * hd, lead=lead, device=device),
         "wo": dense_init(gen, h * hd, d, lead=lead, device=device),
         "wq": dense_init(gen, d, h * hd, lead=lead, device=device),
         "wv": dense_init(gen, d, kv * hd, lead=lead, device=device)}
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((*lead, n * hd), device=device)
    return p


def proj_qkv(p: dict, x: torch.Tensor, cfg, pos: torch.Tensor):
    """q (B, S, H, hd), k and v (B, S, KV, hd) at positions pos (S,)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q, k, v = (x @ p[w].to(dt) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q, k, v = (t.reshape(b, s, -1, hd) for t in (q, k, v))
    if cfg.rope:
        rot = int(hd * cfg.rotary_pct)
        q = apply_rope(q, pos, rot, cfg.rope_theta)
        k = apply_rope(k, pos, rot, cfg.rope_theta)
    return q, k, v


def proj_mla(p: dict, x: torch.Tensor, cfg, pos: torch.Tensor):
    """MLA's projections at positions pos (S,): q (B, S, H, hd + rhd)
    with its last rhd dims rotated, ckv (B, S, lora) rmsnormed, krope
    (B, S, rhd) rotated."""
    b, s, _ = x.shape
    hd, rhd, lora = cfg.resolved_head_dim, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    dkv = x @ p["dkv"].to(x.dtype)
    ckv = norm_fwd({"scale": p["kv_norm"]}, dkv[..., :lora], "rmsnorm")
    krope = apply_rope(dkv[..., lora:][:, :, None, :], pos, rhd,
                       cfg.rope_theta)[:, :, 0]
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, -1, hd + rhd)
    qr = apply_rope(q[..., hd:], pos, rhd, cfg.rope_theta)
    return torch.cat([q[..., :hd], qr], -1), ckv, krope


def mla_expand(p: dict, ckv: torch.Tensor, krope: torch.Tensor, h: int,
               cfg, dtype):
    """Each of the h heads' k (B, S, h, hd + rhd), its RoPE part the
    shared krope, and v (B, S, h, vhd) from the compressed stream (h:
    this rank's heads)."""
    b, s, _ = ckv.shape
    hd = cfg.resolved_head_dim
    k_nope = (ckv @ p["uk"].to(dtype)).reshape(b, s, h, hd)
    v = (ckv @ p["uv"].to(dtype)).reshape(b, s, h, -1)
    k_rope = krope[:, :, None, :].expand(b, s, h, krope.shape[-1])
    return torch.cat([k_nope, k_rope.to(dtype)], -1), v


def absorb_q(p: dict, q: torch.Tensor, cfg):
    """q (B, S, H, hd + rhd) -> (q_lora (B, S, H, lora): its first hd
    dims through the key up-projection, q_rope (B, S, H, rhd))."""
    hd, lora = cfg.resolved_head_dim, cfg.kv_lora_rank
    uk = p["uk"].to(q.dtype).reshape(lora, q.shape[2], hd)
    return torch.einsum("bshd,lhd->bshl", q[..., :hd], uk), q[..., hd:]


def _absorbed_partial(ql, qr, ckv, krope, mask, scale):
    """One key block of absorbed attention: the unnormalised context (B,
    Sq, H, lora) and the running max and sum (B, H, Sq) (``mask`` None:
    every key)."""
    sc = (torch.einsum("bqhl,bsl->bhqs", ql, ckv)
          + torch.einsum("bqhr,bsr->bhqs", qr, krope)).float() * scale
    if mask is not None:
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(-1)
    w = torch.exp(sc - m[..., None])
    return torch.einsum("bhqs,bsl->bqhl", w.to(ckv.dtype), ckv), m, w.sum(-1)


def absorbed_attention(p: dict, q, ckv, krope, cfg, scale: float,
                       causal: bool = True) -> torch.Tensor:
    """Absorbed MLA attention over the prompt (the reference's
    ``_sdpa_absorbed_chunked``), causal or, in an encoder, over every
    key: every query against keys in chunks of ``KV_CHUNK`` with an
    online softmax; (B, S, H, vhd)."""
    ql, qr = absorb_q(p, q, cfg)
    s = ql.shape[1]
    pos = torch.arange(s, device=q.device)
    acc = None
    for k0 in range(0, s, KV_CHUNK):
        mask = mask_from_pos(pos, pos[k0:k0 + KV_CHUNK]) if causal else None
        o, m, l = _absorbed_partial(ql, qr, ckv[:, k0:k0 + KV_CHUNK],
                                    krope[:, k0:k0 + KV_CHUNK], mask, scale)
        if acc is not None:
            o0, m0, l0 = acc
            mn = torch.maximum(m0, m)
            a1, a2 = torch.exp(m0 - mn), torch.exp(m - mn)
            o = o0 * _per_head(a1).to(o.dtype) + o * _per_head(a2).to(o.dtype)
            m, l = mn, l0 * a1 + l * a2
        acc = (o, m, l)
    o, _, l = acc
    return expand_context(p, o / _per_head(l.clamp(min=1e-30)).to(o.dtype),
                          cfg)


def expand_context(p: dict, ctx: torch.Tensor, cfg) -> torch.Tensor:
    """The absorbed form's context (B, Sq, H, lora) through the value
    up-projection: (B, Sq, H, vhd)."""
    uv = p["uv"].to(ctx.dtype).reshape(cfg.kv_lora_rank, ctx.shape[2], -1)
    return torch.einsum("bqhl,lhv->bqhv", ctx, uv)


def _per_head(t):
    """(B, H, Sq) -> a (B, Sq, H, 1) view, to scale a context."""
    return t.permute(0, 2, 1)[..., None]


def _mla_attend(p, q, ckv, krope, cfg, causal: bool = True):
    """MLA attention of the prompt, expanded or absorbed; causal, or
    bidirectional in an encoder."""
    scale = cfg.resolved_head_dim ** -0.5
    if cfg.mla_absorb:
        return absorbed_attention(p, q, ckv, krope, cfg, scale, causal)
    k, v = mla_expand(p, ckv, krope, q.shape[2], cfg, q.dtype)
    return causal_attention(q, k, v, scale) if causal \
        else full_attention(q, k, v, scale)


def mask_from_pos(q_pos: torch.Tensor, k_pos: torch.Tensor,
                  window: int = 0) -> torch.Tensor:
    """(Sq, Sk) causal mask, within ``window`` positions when it is set."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window:
        m = m & (q_pos[:, None] - k_pos[None, :] < window)
    return m


def _scores(q, k, mask, scale):
    """GQA scores (B, KV, G, Sq, Sk) in fp32, masked to NEG_INF (``mask``
    None: every key)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    sc = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    if mask is None:
        return sc
    return torch.where(mask, sc, torch.full_like(sc, NEG_INF))


def _partial(q, k, v, mask, scale):
    """One block's unnormalised output (B, Sq, KV, G, hd) and its running
    max and sum (B, KV, G, Sq) (the reference's ``_sdpa_partial``)."""
    sc = _scores(q, k, mask, scale)
    m = sc.amax(-1)
    w = torch.exp(sc - m[..., None])
    return torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v), m, w.sum(-1)


def _per_query(t):
    """(B, KV, G, Sq) -> a (B, Sq, KV, G, 1) view, to scale an output."""
    return t.permute(0, 3, 1, 2)[..., None]


def _merge(o1, m1, l1, o2, m2, l2):
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    o = o1 * _per_query(a1).to(o1.dtype) + o2 * _per_query(a2).to(o2.dtype)
    return o, m, l1 * a1 + l2 * a2


def _finalize(o, l):
    """(B, Sq, H, hd): the output over its softmax sum."""
    o = o / _per_query(l.clamp(min=1e-30)).to(o.dtype)
    return o.reshape(*o.shape[:2], -1, o.shape[-1])


def _chunked(q, k, v, scale: float, window: int, causal: bool):
    """Scores and softmax in fp32, chunked over queries and keys with an
    online softmax: causal (key chunks above the diagonal skipped) or
    over every key."""
    sq, sk = q.shape[1], k.shape[1]
    pos = torch.arange(max(sq, sk), device=q.device)
    outs = []
    for q0 in range(0, sq, Q_CHUNK):
        qi, qp = q[:, q0:q0 + Q_CHUNK], pos[q0:q0 + Q_CHUNK]
        acc = None
        for k0 in range(0, min(sk, q0 + Q_CHUNK) if causal else sk,
                        KV_CHUNK):
            mask = mask_from_pos(qp, pos[k0:k0 + KV_CHUNK], window) \
                if causal else None
            blk = _partial(qi, k[:, k0:k0 + KV_CHUNK], v[:, k0:k0 + KV_CHUNK],
                           mask, scale)
            acc = blk if acc is None else _merge(*acc, *blk)
        outs.append(_finalize(acc[0], acc[2]))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def causal_attention(q, k, v, scale: float, window: int = 0) -> torch.Tensor:
    """q and k (B, S, H|KV, hd), v (B, S, KV, vhd) with H a multiple of
    KV (GQA) and vhd any width (MLA's v is narrower than its k);
    causal, within ``window`` positions when it is set. Scores and softmax
    in fp32, chunked over queries and keys with an online softmax."""
    return _chunked(q, k, v, scale, window, True)


def full_attention(q, k, v, scale: float) -> torch.Tensor:
    """Bidirectional attention: q (B, Sq, H, hd) over every one of the
    Sk keys of k (B, Sk, KV, hd) and v (B, Sk, KV, vhd), chunked as
    :func:`causal_attention`, unmasked."""
    return _chunked(q, k, v, scale, 0, False)


def _window(cfg) -> int:
    return cfg.window if cfg.attn_kind == "sliding" else 0


def attn_fwd_full(p: dict, x: torch.Tensor, cfg, causal: bool = True,
                  pal=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), causal (sliding with ``attn_kind``) or,
    for an encoder, bidirectional (MLA in either form too).
    Under tensor parallelism this rank's heads, the output summed over
    the model group; with ``pal.sp`` x and the output are this rank's
    sequence chunk (B, S/tp, d), the sequence gathered for attention.
    Under ring attention :func:`ring_fwd`."""
    if ring_on(pal):
        return ring_fwd(p, x, cfg, pal, causal)
    if pal is not None and pal.tp_on:
        sp = pal.sp
        if sp:
            x = all_gather_model(x, pal, 1)
        y = _attn_fwd_local(p, x, cfg, causal, pal)
        return psum_scatter_model(y, pal, 1) if sp else psum_model(y, pal)
    return _attn_fwd_local(p, x, cfg, causal)


def _attn_fwd_local(p: dict, x: torch.Tensor, cfg, causal: bool,
                    pal=None) -> torch.Tensor:
    """This rank's heads of attention over x (B, S, d), through wo's
    rows: the model group's partial sum."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    if cfg.attn_kind == "mla":
        q, ckv, krope = proj_mla(p, x, cfg, pos)
        o = _mla_attend(p, q, ckv, krope, cfg, causal)
    else:
        q, k, v = proj_qkv(p, x, cfg, pos)
        scale = cfg.resolved_head_dim ** -0.5
        o = causal_attention(q, k, v, scale, _window(cfg)) if causal \
            else full_attention(q, k, v, scale)
    o = mask_padded_heads(o, cfg, pal)
    return o.reshape(b, s, -1) @ p["wo"].to(o.dtype)


def ring_fwd(p: dict, x: torch.Tensor, cfg, pal,
             causal: bool = True) -> torch.Tensor:
    """The reference's ``_ring_fwd``: x (B, S_local, d), this rank's
    block of the sequence at global positions r S_local + i, -> its
    block of the output (B, S_local, d), not summed over the model group
    (module docstring). tp hops: at hop i the queries attend to the key
    and value block of model rank (r - i) % tp (its own at hop 0), each
    hop's partial softmax merged into the running one, and the block
    passed on to rank r + 1 for the next hop (no pass after the last)."""
    b, sl, _ = x.shape
    tp, r = pal.tp, axis_index(pal)
    ar = torch.arange(sl, device=x.device)
    pos = r * sl + ar
    mla = cfg.attn_kind == "mla"
    if mla:
        q, ckv, krope = proj_mla(p, x, cfg, pos)
        payload = (ckv, krope)
    else:
        q, k, v = proj_qkv(p, x, cfg, pos)
        payload = (k, v)
    scale = cfg.resolved_head_dim ** -0.5
    window = _window(cfg) if causal else 0
    acc = None
    for i in range(tp):
        if i:
            payload = tuple(ppermute_model(t, pal, 1) for t in payload)
        k_pos = ((r - i) % tp) * sl + ar
        kb, vb = mla_expand(p, *payload, q.shape[2], cfg, x.dtype) if mla \
            else payload
        mask = mask_from_pos(pos, k_pos, window) if causal else None
        blk = _partial(q, kb, vb, mask, scale)
        acc = blk if acc is None else _merge(*acc, *blk)
    o = _finalize(acc[0], acc[2])
    return o.reshape(b, sl, -1) @ p["wo"].to(o.dtype)


def cross_kv(p: dict, enc_out: torch.Tensor, cfg) -> tuple:
    """A decoder layer's cross-attention k and v (B, S_enc, KV, hd): the
    encoder's output through the layer's own wk and wv (and bk, bv), in
    its dtype (the reference's ``init_cross_kv``); under tensor
    parallelism this rank's key/value heads."""
    b, s, _ = enc_out.shape
    dt = enc_out.dtype
    k = enc_out @ p["wk"].to(dt)
    v = enc_out @ p["wv"].to(dt)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    hd = cfg.resolved_head_dim
    return k.reshape(b, s, -1, hd), v.reshape(b, s, -1, hd)


def cross_attention(p: dict, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cfg, pal=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): the queries (no RoPE) over all S_enc
    keys of ``cross_kv``'s k and v (or the cache's copy, in decode).
    Under tensor parallelism this rank's heads (all of them under ring
    attention), the padded ones masked, wo's output summed over the
    model group; with ``pal.sp`` x and the output are this rank's
    sequence chunk, the sequence gathered for the queries and wo's
    output psum-scattered back (the reference's ``cross_kv`` branch)."""
    x = seq_gathered(x, pal)
    b, s, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(b, s, -1, cfg.resolved_head_dim)
    o = mask_padded_heads(full_attention(q, k, v,
                                         cfg.resolved_head_dim ** -0.5),
                          cfg, pal)
    return row_parallel_out(o.reshape(b, s, -1) @ p["wo"].to(o.dtype), pal)


# ---------------------------------------------------------------------------
# Serving: the cache, prefill and decode
# ---------------------------------------------------------------------------

def cache_max_seq(cfg, seq_len: int) -> int:
    """Cache length for a context of ``seq_len`` positions."""
    if cfg.attn_kind == "sliding":
        return min(seq_len, cfg.window)
    return seq_len


# the leaves of an attention layer's decode cache (rows, then slots)
CACHE_KEYS = ("k", "v", "ckv", "krope")


def init_cache(cfg, batch: int, max_seq: int, dtype, *, lead=(),
               device=None, pal=None) -> dict:
    """Zero k and v of ``max_seq`` slots: the whole cache, or under
    context-parallel decode this rank's slice (the caller divides), of
    this rank's key/value heads; for MLA zero ckv (.., lora) and krope
    (.., rhd)."""
    hd = cfg.resolved_head_dim
    if cfg.attn_kind == "mla":
        return {name: torch.zeros((*lead, batch, max_seq, width),
                                  dtype=dtype, device=device)
                for name, width in (("ckv", cfg.kv_lora_rank),
                                    ("krope", cfg.rope_head_dim))}
    shape = (*lead, batch, max_seq, head_counts(cfg, pal)[1], hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill(p: dict, x: torch.Tensor, cache: dict,
                 cfg, pal=None) -> torch.Tensor:
    """Prompt forward x (B, S, d) -> (B, S, d), writing the prompt's k and
    v into ``cache`` (views of one layer, cast to its dtype): the first S
    slots, or, for a sliding window shorter than the prompt, the last
    cap positions at slot position % cap. The prompt attends with the
    uncast k and v. Under tensor parallelism this rank's heads (and cache
    heads; MLA's whole ckv and krope), the output summed over the model
    group."""
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    if cfg.attn_kind == "mla":
        q, ckv, krope = proj_mla(p, x, cfg, pos)
        o = _mla_attend(p, q, ckv, krope, cfg)
        cache["ckv"][:, :s] = ckv
        cache["krope"][:, :s] = krope
        o = mask_padded_heads(o, cfg, pal)
        return psum_model(o.reshape(b, s, -1) @ p["wo"].to(o.dtype), pal)
    q, k, v = proj_qkv(p, x, cfg, pos)
    window = _window(cfg)
    o = causal_attention(q, k, v, cfg.resolved_head_dim ** -0.5, window)
    cap = cache["k"].shape[1]
    if window and s > cap:
        keep = torch.arange(s - cap, s, device=x.device)
        for name, t in (("k", k), ("v", v)):
            cache[name].index_copy_(1, keep % cap,
                                    t[:, s - cap:].to(cache[name].dtype))
    else:
        for name, t in (("k", k), ("v", v)):
            cache[name][:, :s] = t
    o = mask_padded_heads(o, cfg, pal)
    return psum_model(o.reshape(b, s, -1) @ p["wo"].to(o.dtype), pal)


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                cfg, pal=None) -> torch.Tensor:
    """One token x (B, 1, d) at position ``pos`` (a 0-d int tensor on the
    device) -> (B, 1, d). Writes its k and v into ``cache`` in place,
    then attends over the valid slots: slot <= pos, or, in a sliding
    ring buffer of cap slots, the positions pos - ((pos - slot) % cap)
    that are >= 0 and within the window. With ``pal.cache_seq_sharded``
    the cache is this rank's slice of the sequence (module docstring);
    under tensor parallelism this rank's heads, the output summed over the
    model group."""
    b = x.shape[0]
    sharded = pal is not None and pal.cache_seq_sharded
    n, r = (pal.size, pal.rank) if sharded else (1, 0)
    if cfg.attn_kind == "mla":
        o = mask_padded_heads(_mla_decode(p, x, cache, pos, cfg, pal), cfg,
                              pal)
        return psum_model(o.reshape(b, 1, -1) @ p["wo"].to(o.dtype), pal)
    q, k_new, v_new = proj_qkv(p, x, cfg, pos.reshape(1))
    sl = cache["k"].shape[1]
    cap = sl * n
    sliding = cfg.attn_kind == "sliding"
    slot = (pos % min(cfg.window, cap) if sliding else pos).long()
    _cache_write(cache, {"k": k_new, "v": v_new}, slot,
                 r * sl if sharded else None)
    gpos = torch.arange(r * sl, (r + 1) * sl, device=x.device)
    if sliding:
        slot_pos = pos - torch.remainder(pos - gpos, cap)
        valid = (slot_pos >= 0) & (slot_pos <= pos) & \
            (pos - slot_pos < cfg.window)
    else:
        valid = gpos <= pos
    o, m, l = _partial(q, cache["k"], cache["v"], valid[None, :],
                       cfg.resolved_head_dim ** -0.5)
    if sharded:
        o, l = _merge_ranks(o, m, l, _per_query, pal.group)
    o = mask_padded_heads(_finalize(o, l), cfg, pal)
    return psum_model(o.reshape(b, 1, -1) @ p["wo"].to(o.dtype), pal)


def _merge_ranks(o, m, l, per, group):
    """The ranks' partial outputs of one decode step merged over the
    data group: the MAX all-reduce of the running max mg, then the
    rank-order sums of o exp(m - mg) (scaled through ``per``, the view
    that lines the max up with o) and of l exp(m - mg)."""
    mg = all_reduce_max(m, group)
    a = torch.exp(m - mg)
    return (all_reduce_sum(o * per(a).to(o.dtype), group),
            all_reduce_sum(l * a, group))


def _mla_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                cfg, pal=None) -> torch.Tensor:
    """One MLA decode step: the token's ckv and krope written at slot
    ``pos`` (on the rank that owns it under context-parallel decode),
    then attention over slots <= pos, expanded (each head's k and v of
    the cache) or absorbed (over ckv itself); the heads' outputs (B, 1,
    H, vhd), before wo. Under context-parallel decode the ranks' partial
    outputs merge as in the module docstring."""
    sharded = pal is not None and pal.cache_seq_sharded
    r = pal.rank if sharded else 0
    q, ckv, krope = proj_mla(p, x, cfg, pos.reshape(1))
    sl = cache["ckv"].shape[1]
    _cache_write(cache, {"ckv": ckv, "krope": krope}, pos.long(),
                 r * sl if sharded else None)
    gpos = torch.arange(r * sl, (r + 1) * sl, device=x.device)
    valid = gpos <= pos
    scale = cfg.resolved_head_dim ** -0.5
    if cfg.mla_absorb and sharded:
        # the reference's cp branch: an unnormalised context merged over
        # the ranks, then divided by the summed softmax sum
        ql, qr = absorb_q(p, q, cfg)
        ctx, m, l = _absorbed_partial(ql, qr, cache["ckv"], cache["krope"],
                                      valid, scale)
        ctx, l = _merge_ranks(ctx, m, l, _per_head, pal.group)
        return expand_context(
            p, ctx / _per_head(l.clamp(min=1e-30)).to(ctx.dtype), cfg)
    if cfg.mla_absorb:
        # one softmax, normalised before the context product (the
        # reference's one-rank ``_decode_attend_absorbed``)
        ql, qr = absorb_q(p, q, cfg)
        ckv, krope = cache["ckv"], cache["krope"]
        sc = (torch.einsum("bqhl,bsl->bhqs", ql, ckv)
              + torch.einsum("bqhr,bsr->bhqs", qr, krope)).float() * scale
        w = torch.softmax(torch.where(valid, sc, torch.full_like(
            sc, NEG_INF)), -1)
        return expand_context(p, torch.einsum("bhqs,bsl->bqhl",
                                              w.to(ckv.dtype), ckv), cfg)
    k, v = mla_expand(p, cache["ckv"], cache["krope"], q.shape[2], cfg,
                      x.dtype)
    o, m, l = _partial(q, k, v, valid[None, :], scale)
    if sharded:
        o, l = _merge_ranks(o, m, l, _per_query, pal.group)
    return _finalize(o, l)


def _cache_write(cache: dict, new: dict, slot: torch.Tensor,
                 base=None) -> None:
    """Write each step's entry ``new[name]`` (B, 1, ...) into
    ``cache[name]`` in place at ``slot`` (a 0-d device tensor). With
    ``base`` (context-parallel decode) the cache is this rank's slice of
    the slots from global slot ``base`` on: the entry lands at local slot
    slot - base if the slot is the rank's, and otherwise the slice stays
    as it is (a write of the slot's own value, so no step waits on the
    host: the reference's ``_cache_write``)."""
    for name, t in new.items():
        arr = cache[name]
        if base is None:
            arr.index_copy_(1, slot.reshape(1), t.to(arr.dtype))
            continue
        local, sl = slot - base, arr.shape[1]
        inb = (local >= 0) & (local < sl)
        at = local.clamp(0, sl - 1).reshape(1)
        arr.index_copy_(1, at, torch.where(inb, t.to(arr.dtype),
                                           arr.index_select(1, at)))
