"""Configuration dataclasses + registry (the port's own copy).

Field names and defaults follow the reference's ``repro.configs.base`` so
a config reads the same in both packages: the dense decoder family (every dense layout of the
registry: layernorm or rmsnorm, the SwiGLU or the GELU MLP, QKV bias,
tied or untied embeddings, RoPE or sinusoidal positions, full or sliding
attention), the MoE family (routed and shared experts, a dense prefix,
MLA attention expanded or absorbed), the recurrent families (xLSTM's
mLSTM and sLSTM mixers; Mamba, alone or in the Jamba hybrid with
attention and MoE layers), the vision and audio families (a patch stub
over the decoder's first positions; an encoder over a frame stub with
cross-attention in every decoder layer), the sparsifier fields that
select among its paths, the optimizers, the four input shapes
(``SHAPES``) and the active parameter count (``active_param_count``). A
field value the reference does not define raises ``ValueError`` where it
would be used (``core.sparsify.check_supported``,
``core.aggregate.check_supported``, ``models.transformer.check_model``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared_experts: int = 0     # always-on experts (deepseek-v2 style)
    top_k: int = 0
    d_expert: int = 0             # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    moe_every: int = 1            # MoE FFN on layers where
                                  # (idx % moe_every == moe_offset)
    moe_offset: int = 0
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"           # mamba | xlstm
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: int = 0              # 0 -> ceil(d_model/16)
    # xlstm
    slstm_proj_factor: float = 4 / 3
    mlstm_proj_factor: float = 2.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    source: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    rope: bool = True
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0       # stablelm uses partial rotary (0.25)
    qkv_bias: bool = False
    attn_kind: str = "full"       # full | sliding | mla
    window: int = 8192            # sliding window size
    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0           # 0 -> head_dim
    mla_absorb: bool = False      # absorbed attention: scores and context
                                  # in the compressed kv_lora space
    # block structure
    attn_every: int = 1           # period of attention layers; rest SSM
    attn_offset: int = 0
    n_dense_prefix: int = 0       # leading layers with a dense FFN
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_causal: bool = False      # the encoder is bidirectional, as the
                                  # reference's: True raises ValueError
    # modality frontend stubs
    frontend: str = "none"        # none | vision_stub | audio_stub
    n_frontend_tokens: int = 0    # patches (vlm) / frames (audio)
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "silu"             # silu (swiglu) | gelu (plain mlp)
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count, exact for the port's init as
        ``repro.models.params`` counts the reference's: every dense
        layout, MLA, routed and shared experts, the dense prefix, the
        Mamba, mLSTM and sLSTM mixers (a Mamba layer has ``norm1``
        before its mixer; an mLSTM or sLSTM layer has its norm inside
        the mixer, counted as the reference counts it, 2 d)."""
        d, hd = self.d_model, self.resolved_head_dim
        h, kv = self.n_heads, self.n_kv_heads
        norm = d * (2 if self.norm == "layernorm" else 1)
        if self.attn_kind == "mla":
            lora, rhd = self.kv_lora_rank, self.rope_head_dim
            vhd = self.v_head_dim or hd
            attn = (d * (lora + rhd) + lora + lora * h * hd + lora * h * vhd
                    + d * h * (hd + rhd) + h * vhd * d)
        else:
            attn = d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.qkv_bias:
                attn += h * hd + 2 * kv * hd
        mixer = {"attn": norm + attn}
        if self.ssm is not None:
            s = self.ssm
            (di, dtr), ds = mamba_dims(self), s.d_state
            mixer["mamba"] = (norm + 2 * d * di + s.d_conv * di + di
                              + di * (dtr + 2 * ds) + dtr * di + di
                              + di * ds + di + di * d)
            dm = mlstm_dims(self)[0]
            mixer["mlstm"] = 2 * d + 2 * d * dm + 3 * dm * dm + 2 * h * dm \
                + dm + dm * d
            dsl = slstm_dims(self)
            mixer["slstm"] = 2 * d + 4 * d * dsl + dsl + dsl * d

        def mlp(d_ff):
            if self.act == "silu":
                return 3 * d * d_ff                    # gate, up, down
            return 2 * d * d_ff + d_ff + d             # up, down + biases
        ffn = {"dense": norm + mlp(self.d_ff), "none": 0}
        if self.moe is not None:
            m = self.moe
            per_expert = (3 if self.act == "silu" else 2) * d * m.d_expert
            ffn["moe"] = norm + d * m.n_experts + m.n_experts * per_expert
            if m.n_shared_experts:
                ffn["moe"] += mlp(m.d_expert * m.n_shared_experts)
        cross = (norm + attn) if self.is_encoder_decoder else 0
        pattern = layer_pattern(self)
        body = self.n_layers - self.n_dense_prefix
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n += norm + self.n_dense_prefix * (mixer[pattern[0][0]] + cross
                                           + ffn["dense"])
        n += body // len(pattern) * sum(mixer[m] + cross + ffn[f]
                                        for m, f in pattern)
        if self.is_encoder_decoder:
            n += self.n_enc_layers * (mixer["attn"] + ffn["dense"]) + norm
        return n


def active_param_count(cfg) -> int:
    """Parameters a token passes through (the reference's
    ``count_active_params``): ``param_count`` with each MoE layer's
    routed experts cut to its top-k (the router and the shared experts
    stay whole)."""
    total = cfg.param_count()
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = (3 if cfg.act == "silu" else 2) * cfg.d_model * m.d_expert
    period, kinds = ffn_pattern(cfg)
    n_moe = (cfg.n_layers - cfg.n_dense_prefix) // period * kinds.count("moe")
    return total - n_moe * (m.n_experts - m.top_k) * per_expert


def mamba_dims(cfg) -> tuple:
    """(d_inner, dt_rank) of a Mamba mixer: expand * d_model, and the
    config's dt_rank or ceil(d_model / 16)."""
    return (cfg.ssm.expand * cfg.d_model,
            cfg.ssm.dt_rank or max(1, -(-cfg.d_model // 16)))


def mlstm_dims(cfg) -> tuple:
    """(d_inner, heads, head dim) of an mLSTM mixer: d_inner =
    int(mlstm_proj_factor * d_model) over the config's heads."""
    d_inner = int(cfg.ssm.mlstm_proj_factor * cfg.d_model)
    return d_inner, cfg.n_heads, d_inner // cfg.n_heads


def slstm_dims(cfg) -> int:
    """d_inner of an sLSTM mixer: slstm_proj_factor * d_model rounded up
    to a multiple of 16."""
    return -(-int(cfg.ssm.slstm_proj_factor * cfg.d_model) // 16) * 16


def layer_pattern(cfg) -> list:
    """[(mixer, ffn)] for one super-block period (the reference's
    ``layer_pattern``). mixer: attn | mamba | mlstm | slstm (xLSTM
    alternates mLSTM and sLSTM; a hybrid has attention where idx %
    attn_every == attn_offset and its SSM elsewhere); ffn: dense | moe |
    none (``ffn_pattern``)."""
    p, kinds = ffn_pattern(cfg)
    out = []
    for j in range(p):
        if cfg.attn_every == 0:
            mixer = "mlstm" if (cfg.ssm.kind == "xlstm" and j % 2 == 0) \
                else ("slstm" if cfg.ssm.kind == "xlstm" else "mamba")
        elif cfg.attn_every == 1 or j % cfg.attn_every == cfg.attn_offset:
            mixer = "attn"
        else:
            mixer = cfg.ssm.kind if cfg.ssm.kind != "xlstm" else "mlstm"
        out.append((mixer, kinds[j]))
    return out


def ffn_pattern(cfg) -> tuple:
    """(period, [ffn kind of each layer of a super-block]): the
    reference's ``superblock_period`` and the FFN half of its
    ``layer_pattern`` ("moe" where idx % moe_every == moe_offset, else
    "dense", or "none" without a d_ff)."""
    p = 1
    if cfg.ssm is not None and cfg.ssm.kind == "xlstm":
        p = 2
    if cfg.attn_every > 1:
        p = max(p, cfg.attn_every)
    if cfg.moe is not None:
        p = max(p, cfg.moe.moe_every)
    kinds = []
    for j in range(p):
        if cfg.moe is not None and j % cfg.moe.moe_every == cfg.moe.moe_offset:
            kinds.append("moe")
        else:
            kinds.append("dense" if cfg.d_ff > 0 else "none")
    return p, kinds


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class SparsifierConfig:
    """The paper's knobs (see the reference's docstrings for each field).
    The port serves kind in {topk, dgc, regtopk, thresholdk, randk} on
    both pipelines (the fused two-sweep pipeline with the exact or the
    histogram selector, any ``num_buckets`` >= 1, fp32 or bf16 error
    feedback; the reference pipeline with the exact, histogram and
    histogram_kernel selectors, REGTOP-k with either ``state_format``,
    bf16 error feedback with the exact selector for kinds but REGTOP-k),
    kind="sketchtopk" on both with the exact selector, one bucket and
    fp32, and the baselines kind="none" (dense SGD) and
    kind="globaltopk" (the genie, any selector); sparse (on the fp32 or
    bf16 wire), simulate or dense comm; elastic participation
    (``combine``, ``err_decay``) on every kind but sketchtopk; density
    allocation (``allocation``, ``num_segments``) on the kinds of
    ``core.allocate.ALLOCATED_KINDS`` with the exact selector, and
    streaming (``overlap="backward"``) on the fused pipeline. The fields
    past ``momentum`` exist to select among the reference's paths and
    raise for any other value."""
    kind: str = "regtopk"
    sparsity: float = 0.01
    k: int = 0                    # explicit k; 0 -> derive from sparsity
    mu: float = 0.1               # REGTOP-k regularizer temperature
    Q: float = 0.0                # posterior distortion for never-sent entries
    momentum: float = 0.9         # dgc momentum correction
    allocation: str = "global"    # global | proportional | adaptive
    num_segments: int = 0         # allocation's segment count (0: the
                                  # buckets' when > 1, else 8)
    comm_mode: str = "simulate"
    selector: str = "exact"
    ef_dtype: str = "float32"
    wire_dtype: str = "float32"
    pipeline: str = "reference"
    state_format: str = "dense"   # dense | sparse (reference-pipeline
                                  # REGTOP-k; the fused pipeline ignores it)
    num_buckets: int = 1
    combine: str = "mean"         # elastic combine: mean | support
    overlap: str = "none"
    err_decay: float = 1.0        # EF decay of a sitting-out worker
    # sketchtopk: CountSketch-coordinated global TOP-k
    sketch_rows: int = 3
    sketch_width: int = 0         # 0 -> min(max(4k, 256), 2^22)


@dataclass(frozen=True)
class OptimizerConfig:
    """The reference's optimizer fields and defaults. The state is
    always ZeRO-1 sharded over the data ranks: the reference reads no
    ``zero1`` field and shards whatever its value, and so does the port."""
    kind: str = "sgd"             # sgd | momentum | adam | adamw
    lr: float = 1e-2
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    warmup_steps: int = 0
    schedule: str = "constant"    # constant | cosine
    total_steps: int = 10_000
    zero1: bool = True            # shard optimizer state over data axis


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    sparsifier: SparsifierConfig = SparsifierConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    fault_schedule: str = ""      # core.faults spec; "" = every worker in
    attn_override: str = ""       # "sliding": the dense arch's sliding variant
    checkpoint_dir: str = ""      # "" = no checkpoints
    checkpoint_every: int = 0     # steps between checkpoints (0: the end only)


def resolve_model_cfg(run: RunConfig) -> ModelConfig:
    """The model a run trains or serves: ``attn_override="sliding"`` turns
    a full-attention model into its sliding-window variant (the
    reference's ``repro.train.step.resolve_model_cfg``)."""
    cfg = run.model
    if run.attn_override == "sliding" and cfg.attn_kind == "full":
        cfg = replace(cfg, attn_kind="sliding")
    return cfg


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_ARCH_MODULES = ["stablelm_3b", "starcoder2_7b", "qwen1_5_32b",
                 "phi_3_vision_4_2b", "granite_8b", "granite_moe_3b_a800m",
                 "xlstm_125m", "whisper_small", "jamba_v0_1_52b",
                 "deepseek_v2_lite_16b"]


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def _load_all() -> None:
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def list_archs() -> list:
    _load_all()
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """The reference's smoke variant of a config: one super-block period
    of at least 2 layers plus the dense prefix, d_model 128, 4 heads of
    32, d_ff 256, vocab 512, window 64, max_seq_len 4096, fp32; MoE cut
    to 4 experts of 64, top-2, at most one shared expert; MLA to lora 32,
    rope dim 16 and v dim 32; an SSM to d_state 8, d_conv 4; an encoder
    to at most 2 layers and a frontend stub to at most 16 patches or
    frames (the reference's ``reduced_config``)."""
    period = ffn_pattern(cfg)[0]
    n_kv = min(cfg.n_kv_heads, 4)
    if 4 % n_kv:
        n_kv = 2
    moe = None
    if cfg.moe is not None:
        moe = replace(cfg.moe, n_experts=4, top_k=min(2, cfg.moe.top_k),
                      n_shared_experts=min(1, cfg.moe.n_shared_experts),
                      d_expert=64)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = replace(ssm, d_state=8, d_conv=4)
    return replace(
        cfg, name=cfg.name + "-smoke",
        n_layers=max(2, period) + cfg.n_dense_prefix, d_model=128,
        n_heads=4, n_kv_heads=n_kv, head_dim=32, d_ff=256, vocab_size=512,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0, q_lora_rank=0,
        rope_head_dim=16 if cfg.kv_lora_rank else 64,
        v_head_dim=32 if cfg.v_head_dim else 0, moe=moe, ssm=ssm,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16), window=64,
        dtype="float32", max_seq_len=4096)
