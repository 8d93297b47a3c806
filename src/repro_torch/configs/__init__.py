"""Model configurations the port serves: importing this package populates
the LM architecture registry (``esn_paper`` holds the reservoir configs)."""

from repro_torch.configs import (deepseek_v2_236b, gemma_2b,  # noqa
                                 internvl2_76b, mistral_nemo_12b,
                                 olmoe_1b_7b, qwen3_32b, recurrentgemma_2b,
                                 stablelm_1_6b, whisper_base, xlstm_350m)
from repro_torch.configs.base import (SHAPES, ModelConfig,  # noqa
                                      ShapeSpec, get_config, list_archs,
                                      supports_shape)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to CPU-smoke size, preserving its structural family.

    Same block pattern, same attention variant (GQA ratio, MLA, qk-norm),
    same routing (top-k, shared experts) — just tiny dims.
    """
    kw = dict(
        n_layers=len(cfg.block_pattern) * 2,   # two stacked groups
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        window=16 if cfg.window else None,
        lru_dim=64 if cfg.lru_dim else None,
        remat="none",
    )
    if cfg.moe is not None:
        # capacity_factor covers every assignment at smoke scale so the
        # prefill and decode paths route identically
        kw["moe"] = cfg.moe.__class__(
            n_experts=8, top_k=min(cfg.moe.top_k, 2), d_expert=32,
            n_shared=min(cfg.moe.n_shared, 1), capacity_factor=8.0)
    if cfg.mla is not None:
        kw["mla"] = cfg.mla.__class__(kv_lora=32, q_lora=48, rope_dim=8,
                                      nope_dim=16, v_dim=16)
        kw["head_dim"] = 24  # nope + rope
    if cfg.encoder is not None:
        kw["encoder"] = cfg.encoder.__class__(n_layers=2, seq_len=12)
    return cfg.replace(**kw)
