"""Analytic per-device memory model for a mesh of cards (the port of
``repro.roofline.memory_model``): does a configuration fit one card's
memory? Exact for the parameter, state and cache residency that the
split rules give; the activations are the remat working-set estimate.

Beyond the resident breakdown it gives the PEAK bytes of a train step:
the compress stage's transient working buffers (the fused sweeps' ``a``
and ``score`` streams, or the reference pipeline's longer dense chain)
live beside the resident state, and, when the step does not donate the
error-feedback state (the port's train step does: ``TrainStep`` hands
the old state to the sync), every step briefly holds two copies of the
J-sized state vectors it rewrites. ``MemoryBreakdown.peak`` counts both;
``fits_hbm`` gates on it. The arithmetic is the reference's, term for
term; only ``fits_hbm``'s default capacity is the H100's.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import RunConfig, ffn_pattern

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (chip_smoke.py, line roofline)
H100_TOTAL_MEMORY = 85_017_493_504


@dataclass
class MemoryBreakdown:
    params: float
    grads: float
    opt: float
    ef: float
    cache: float
    activations: float
    # transient compress working set (fused: the a/score fp32 streams;
    # reference: its longer dense score/mask/ghat chain); zero outside
    # train steps
    compress_transient: float = 0.0
    # extra J-sized state copies alive while the step rewrites err/mom
    # buffers that were not donated (0 when donated)
    state_double_buffer: float = 0.0

    @property
    def total(self):
        """Resident bytes (state and the activation working set)."""
        return (self.params + self.grads + self.opt + self.ef + self.cache +
                self.activations)

    @property
    def peak(self):
        """Peak bytes a step: resident, compress transients and any
        undonated state double-buffering."""
        return self.total + self.compress_transient + self.state_double_buffer


def _dtype_bytes(dt: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[dt]


def per_device_memory(run: RunConfig, *, tp=16, dp=16, kind="train",
                      state_format=None, ef_dtype=None,
                      donate_ef: bool = True) -> MemoryBreakdown:
    """One card's bytes on a (dp, tp) mesh. ``donate_ef=False`` models a
    step that does not donate the error-feedback state: the J-sized
    vectors it rewrites (err_prev, DGC's mom, the reference layouts'
    err/a_prev/s_prev) are then briefly held twice
    (``state_double_buffer``). Density allocation keeps the same J-sized
    state and k-sized pairs in every mode (its O(segments) counts and
    O(k) trim buffers are below this model's resolution), so it has no
    branch here."""
    from repro_torch.core.sparsify import resolve_k
    from repro_torch.kernels.compress.dispatch import fused as _fused
    cfg = run.model
    sp = run.sparsifier
    state_format = state_format or sp.state_format
    ef_dtype = ef_dtype or sp.ef_dtype
    shape = run.shape
    n = cfg.param_count()
    j_local = n / tp                       # flat per-(data, model)-rank vector
    pb = _dtype_bytes(cfg.dtype)
    params = n / tp * pb
    if kind != "train":
        b_local = max(shape.global_batch // dp, 1)
        cache = 0.0
        if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            # KV cache (full or sliding window), seq split when batch < dp
            kv = cfg.n_kv_heads
            kvp = -(-kv // tp) * tp
            hd = cfg.resolved_head_dim
            seq = shape.seq_len
            if cfg.attn_kind == "sliding" or (shape.name == "long_500k"
                                              and cfg.attn_kind == "full"):
                seq = min(seq, cfg.window)
            seq_local = seq if shape.global_batch >= dp else seq // dp
            n_attn = cfg.n_layers if cfg.attn_every <= 1 else \
                cfg.n_layers // cfg.attn_every
            if cfg.attn_kind == "mla":
                per_tok = cfg.kv_lora_rank + cfg.rope_head_dim
            else:
                per_tok = 2 * (kvp // tp) * hd
            cache = b_local * seq_local * per_tok * pb * n_attn
        return MemoryBreakdown(params, 0, 0, 0, cache,
                               0.1e9)  # decode activations are tiny
    grads = j_local * 4                    # fp32 flat gradient (transient)
    opt = 3 * (j_local / dp) * 4           # ZeRO-1 master, m, v in fp32
    efb = _dtype_bytes(ef_dtype)
    k = resolve_k(sp, int(j_local))
    fused = _fused(sp)
    if fused:
        # the two-sweep layout: one J-sized vector (err_prev; and mom for
        # DGC) and REGTOP-k's O(k) posterior
        ef = j_local * efb * (2 if sp.kind == "dgc" else 1)
        if sp.kind == "regtopk":
            ef += k * (4 + 2 * efb)        # idx u32 + a_sel/g_sel
    elif sp.kind == "regtopk" and state_format == "dense":
        ef = (1 * j_local + 3 * j_local) * efb     # err + a_prev+s_prev+g_prev
    elif sp.kind == "regtopk":
        ef = j_local * efb + 3 * k * 4
    elif sp.kind in ("topk", "thresholdk", "sketchtopk", "randk"):
        ef = j_local * efb
    elif sp.kind == "dgc":
        ef = 2 * j_local * efb
    else:
        ef = 0.0
    # the fused sweeps stream two fp32 J-vectors (a, score); the reference
    # chain holds about four (a, score, mask, ghat)
    if sp.kind in ("none", "globaltopk"):
        compress_transient = 0.0
    elif fused:
        compress_transient = 2 * j_local * 4
    else:
        compress_transient = 4 * j_local * 4
    state_double_buffer = 0.0 if donate_ef else ef
    # activations: remat keeps one super-block working set + layer inputs
    b_local = shape.global_batch // dp
    seq_local = shape.seq_len // tp        # SP-split residual stream
    period = ffn_pattern(cfg)[0]
    nsb = (cfg.n_layers - cfg.n_dense_prefix) // period
    resid = b_local * shape.seq_len * cfg.d_model * pb  # gathered, transient
    saved = nsb * b_local * seq_local * cfg.d_model * pb * period
    activations = saved + 4 * resid
    return MemoryBreakdown(params, grads, opt, ef, 0.0, activations,
                           compress_transient, state_double_buffer)


def fits_hbm(run: RunConfig, hbm_bytes=H100_TOTAL_MEMORY, **kw) -> tuple:
    """(peak <= hbm_bytes, the breakdown): gates on the peak bytes a step
    (resident, compress transients and any undonated state), not on the
    residency alone."""
    mb = per_device_memory(run, **kw)
    return mb.peak <= hbm_bytes, mb
