"""Unified model configuration + registry of the LM architectures.

The port's own copy of the JAX package's ``configs/base.py`` (plain
dataclasses, no framework), kept field for field so a config means the same
model in both packages.  Every architecture is expressible as a
``ModelConfig``: a stack of repeated *block groups* (so heterogeneous
patterns like RecurrentGemma's recurrent/recurrent/local-attention triple
still stack), a family tag, and optional MoE / MLA / recurrent
sub-configs.

``reduced()`` shrinks any config to a CPU-smokeable size while preserving
its structural family (same block pattern, same attention variant, same
routing).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoEConfig", "MLAConfig", "EncoderConfig", "ModelConfig",
           "ShapeSpec", "SHAPES", "register", "get_config", "list_archs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # always-on shared experts
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""
    kv_lora: int = 512
    q_lora: int = 1536
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) / frontend token count (vlm)."""
    n_layers: int = 6
    seq_len: int = 1500           # whisper: 30 s audio -> 1500 frames
    is_causal: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm | esn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # block pattern repeated over the depth; len(pattern) divides into
    # n_layers with an optional remainder tail.
    block_pattern: tuple = ("attn",)

    # attention details
    qk_norm: bool = False
    window: Optional[int] = None          # local attention window
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0            # stablelm: partial rotary
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    mlp_act: str = "silu"                 # silu | geglu | gelu
    logit_softcap: Optional[float] = None

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None        # audio | vision (stub embeddings)

    # recurrent dims
    lru_dim: Optional[int] = None         # RG-LRU width
    conv_width: int = 4                   # temporal conv in recurrent blocks

    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # training-time structure
    remat: str = "full"                   # none | dots | full
    scan_layers: bool = True
    # gradient-accumulation microbatches for train_4k (memory fit); chosen
    # per arch so every train cell's activations fit 16 GB/device HBM.
    microbatches: int = 1
    # tensor-parallel mapping: when False the 'model' mesh axis is used as
    # additional FSDP instead of TP (better for collective-bound dense
    # models that fit without TP) — a §Perf lever, default paper-baseline on.
    use_tp: bool = True

    # paper-technique integration: frozen-weight serving specialization
    # (int8 symmetric quantization of all big weights; the paper's "matrix
    # fixed for the lifetime of the computation" applied to LM serving)
    frozen_sparse_serving: bool = False
    # FSDP-shard expert weights over the data axes (baseline True; False
    # keeps experts EP-resident — kills per-microbatch expert gathers)
    expert_fsdp: bool = True
    # AdamW m/v dtype ("float32" | "bfloat16")
    opt_dtype: str = "float32"
    # FSDP-shard weights at serving time (baseline True = same sharding as
    # train; False keeps weights TP-resident — no per-token weight gathers)
    serving_fsdp: bool = True
    # global FSDP toggle (False = replicate weights over the data axes;
    # right for small models where FSDP'd contractions force activation
    # all-reduces)
    fsdp: bool = True

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def tail_pattern(self) -> tuple:
        rem = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: dict = {}


def register(cfg_or_fn):
    """Register a ModelConfig (or a zero-arg factory) under its name."""
    cfg = cfg_or_fn() if callable(cfg_or_fn) else cfg_or_fn
    _REGISTRY[cfg.name] = cfg
    return cfg_or_fn


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch module imports)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether a (arch x shape) cell runs; reasons documented in DESIGN.md."""
    sub_quadratic = all(b in ("rglru", "local", "mlstm", "slstm")
                        for b in cfg.block_pattern)
    if shape.name == "long_500k" and not sub_quadratic:
        return False, ("SKIP: pure full-attention arch; a 524288-token dense "
                       "KV cache is not sub-quadratic (DESIGN.md §Shapes)")
    return True, ""
