"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, mlp_act="geglu",
    block_pattern=("rglru", "rglru", "local"), window=2048, lru_dim=2560,
    logit_softcap=30.0, tie_embeddings=True,
    microbatches=4,
))
