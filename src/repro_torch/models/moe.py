"""Mixture-of-Experts FFN: fixed-capacity top-k routing (GShard/Switch
style) with optional shared experts, and expert parallelism over the
model group (the port of ``repro.models.moe``).

Per call on n tokens of d:

1. router logits (n, E) in fp32, their softmax, and each token's top-k
   experts in ``lax.top_k`` order (``core.select.topk_positions``), the
   k probabilities renormalised to sum 1;
2. the aux terms: the Switch load-balance loss E * sum(mean prob *
   mean routed count), the router z-loss mean(logsumexp^2), and the
   share of choices dropped;
3. slots: the (token, choice) pairs in token-major order (a token's k
   choices inner, as the reference's reshape lays them), each taking the
   next free slot of its expert's queue of ``capacity`` slots; a choice
   past the capacity is dropped;
4. dispatch: each kept choice adds its token to its (expert, slot) row
   of an (E * cap + 1, d) buffer, the dropped ones to the extra last
   row, which is cut off;
5. the experts' SwiGLU (or GELU) FFN as batched matrix products over
   (E, cap, d);
6. combine: each choice reads its row back (a dropped one a zero row),
   weighted by its probability, summed over the k choices in order;
   plus the shared experts' dense MLP on every token.

Under tensor parallelism (a model group of tp ranks) the experts are
padded to a multiple of tp (a padded expert's router logit is -1e30, so
no token picks it) and rank r holds experts [r E_pad/tp, (r + 1)
E_pad/tp). Each rank routes its own tokens (its sequence chunk under
sequence parallelism), with a capacity from its own token count over
E_pad experts, into an (E_pad, cap, d) buffer; an ``all_to_all`` (split
the experts, concatenate the capacity in source rank order) hands each
rank its experts' slots from every rank, (E_pad/tp, tp cap, d), the
experts run there, and the inverse ``all_to_all`` returns the outputs.
The aux terms count the real experts only. Shared experts run as the
column/row-parallel MLP.

The reference's TPU program is plain jnp here, no Pallas kernel; the
port keeps it plain PyTorch. The capacity depends on the token count,
so a prefill, a decode step and a full forward of the same text may
drop different choices (``capacity_factor`` 16 drops none).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.core.select import topk_positions
from repro_torch.models.layers import dense_init, gelu_tanh, init_mlp, mlp_fwd
from repro_torch.models.parallel import all_to_all_model, pad_to, shard_slice


def experts_padded(cfg, pal=None) -> int:
    """The expert count padded to a multiple of the model group's size."""
    return pad_to(cfg.moe.n_experts, 1 if pal is None else pal.tp)


def init_moe(gen, cfg, *, lead=(), device=None, pal=None) -> dict:
    """{router (d, E), gate, up (E, d, d_expert), down (E, d_expert, d)}
    and, with shared experts, {shared}: a dense MLP of width d_expert *
    n_shared_experts; under tensor parallelism the router over the padded
    experts and this rank's share of the expert stacks."""
    m, d = cfg.moe, cfg.d_model
    e_pad = experts_padded(cfg, pal)
    e = shard_slice(e_pad, pal)

    def expert_stack(d_in, d_out):
        return torch.randn((*lead, e, d_in, d_out), generator=gen,
                           device=device) * d_in ** -0.5
    p = {"router": dense_init(gen, d, e_pad, scale=0.02, lead=lead,
                              device=device),
         "gate": expert_stack(d, m.d_expert),
         "up": expert_stack(d, m.d_expert),
         "down": expert_stack(m.d_expert, d)}
    if m.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=m.d_expert * m.n_shared_experts,
                               lead=lead, device=device, pal=pal)
    return p


def capacity(n_tokens: int, n_experts: int, top_k: int,
             factor: float) -> int:
    """Slots an expert: n * k / E * factor, rounded up to a multiple of
    8, at least 8."""
    c = int(n_tokens * top_k / n_experts * factor)
    return max(8, -(-c // 8) * 8)


def route(logits: torch.Tensor, cfg) -> dict:
    """Routing of (n, E) fp32 router logits (E the padded count, the
    padded experts' logits -1e30): {top_p (n, k) renormalised, top_e (n,
    k) int64, slot and keep (n * k,) in token-major order, cap, lb_loss,
    z_loss, drop_frac}; lb_loss over the real experts."""
    m = cfg.moe
    n, e = logits.shape
    real = m.n_experts
    probs = torch.softmax(logits, -1)
    top_e = topk_positions(probs, m.top_k)
    top_p = torch.gather(probs, 1, top_e)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    sel = F.one_hot(top_e.reshape(-1), e)                 # (n * k, E)
    fe = sel.reshape(n, m.top_k, e).sum(1).float().mean(0)[:real]
    lb_loss = real * torch.sum(probs[:, :real].mean(0) * fe)
    z_loss = torch.mean(torch.logsumexp(logits, -1) ** 2)
    cap = capacity(n, e, m.top_k, m.capacity_factor)
    # the choices of the same expert before this one, in flat order
    slot = ((torch.cumsum(sel, 0) - sel) * sel).sum(-1)
    keep = slot < cap
    return {"top_p": top_p, "top_e": top_e, "slot": slot, "keep": keep,
            "cap": cap, "lb_loss": lb_loss, "z_loss": z_loss,
            "drop_frac": 1.0 - keep.float().mean()}


def moe_fwd(p: dict, x: torch.Tensor, cfg, pal=None) -> tuple:
    """x (B, T, d) -> (y (B, T, d), {lb_loss, z_loss, drop_frac}); under
    tensor parallelism x is this rank's tokens and the experts are split
    over the model group (module docstring)."""
    m = cfg.moe
    b, t, d = x.shape
    xt = x.reshape(b * t, d)
    n, e, dt = b * t, experts_padded(cfg, pal), x.dtype
    logits = (xt @ p["router"].to(dt)).float()
    if e > m.n_experts:
        logits = torch.where(torch.arange(e, device=x.device) >= m.n_experts,
                             torch.full_like(logits, -1e30), logits)
    r = route(logits, cfg)
    cap = r["cap"]
    expert = r["top_e"].reshape(-1)
    drop_row = torch.full_like(expert, e * cap)
    flat_idx = torch.where(r["keep"], expert * cap + r["slot"], drop_row)
    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=x.device)
    buf = buf.index_add(0, flat_idx, xt.repeat_interleave(m.top_k, 0))
    with trace.span("moe/all_to_all"):
        buf = all_to_all_model(buf[:-1].reshape(e, cap, d), pal, 0, 1)
    if cfg.act == "silu":
        h = F.silu(torch.bmm(buf, p["gate"].to(dt))) * \
            torch.bmm(buf, p["up"].to(dt))
    else:
        h = gelu_tanh(torch.bmm(buf, p["up"].to(dt)))
    out = torch.bmm(h, p["down"].to(dt))
    with trace.span("moe/all_to_all"):
        out = all_to_all_model(out, pal, 1, 0).reshape(e * cap, d)
    out = torch.cat([out, out.new_zeros(1, d)], 0)
    w = (r["top_p"].reshape(-1) * r["keep"]).to(dt)
    y = (out[flat_idx] * w[:, None]).reshape(n, m.top_k, d).sum(1)
    y = y.reshape(b, t, d)
    if m.n_shared_experts:
        y = y + mlp_fwd(p["shared"], x, cfg, pal)
    return y, {key: r[key] for key in ("lb_loss", "z_loss", "drop_frac")}
