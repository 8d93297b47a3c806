"""OLMoE-1B-7B: 64-expert top-8 MoE [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=50304, qk_norm=True, tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
    microbatches=2,
))
