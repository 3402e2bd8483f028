"""Configuration dataclasses + registry (the port's own copy).

Field names and defaults follow the reference's ``repro.configs.base`` so
a config reads the same in both packages. Only what the ported slice
runs is here: the dense decoder family, the sparsifier fields that select
among its paths, and the optimizers. A field value outside the slice raises
``NotImplementedError`` naming its ROADMAP item where it would be used
(``core.sparsify.check_supported``, ``core.aggregate.check_supported``,
``models.transformer.check_model``, ``optim.optimizer.check_optimizer``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense (the only family ported so far)
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
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"         # layernorm is ported (rmsnorm: ROADMAP A7)
    act: str = "silu"             # silu (swiglu)
    tie_embeddings: bool = False
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count of the dense decoder (exact for the
        port's init, which mirrors the reference's shapes)."""
        d, hd = self.d_model, self.resolved_head_dim
        norm = 2 * d                                   # layernorm
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        mlp = 3 * d * self.d_ff                        # swiglu
        n = 2 * self.vocab_size * d + norm             # untied embed + head
        return n + self.n_layers * (2 * norm + attn + mlp)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
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
    kind="globaltopk" (the genie, any selector); all with global
    allocation, sparse (on the fp32 or bf16 wire), simulate or dense
    comm; elastic participation (``combine``, ``err_decay``) on every
    kind but sketchtopk. The fields past ``momentum`` exist to select
    among the reference's paths and raise for any other value."""
    kind: str = "regtopk"
    sparsity: float = 0.01
    k: int = 0                    # explicit k; 0 -> derive from sparsity
    mu: float = 0.1               # REGTOP-k regularizer temperature
    Q: float = 0.0                # posterior distortion for never-sent entries
    momentum: float = 0.9         # dgc momentum correction
    allocation: str = "global"
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
    """The reference's optimizer fields and defaults, ZeRO-1 sharded.
    ``zero1=False`` raises (ROADMAP A7)."""
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


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_ARCH_MODULES = ["stablelm_3b"]


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def _load_all() -> None:
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port knows "
                       f"{sorted(_REGISTRY)} (other families: ROADMAP A13)")
    return _REGISTRY[name]()


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """The reference's smoke variant of a dense config: 2 layers,
    d_model 128, 4 heads of 32, d_ff 256, vocab 512, fp32."""
    n_kv = min(cfg.n_kv_heads, 4)
    if 4 % n_kv:
        n_kv = 2
    return replace(
        cfg, name=cfg.name + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=n_kv, head_dim=32, d_ff=256, vocab_size=512,
        dtype="float32")
