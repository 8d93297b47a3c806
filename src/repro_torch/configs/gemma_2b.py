"""Gemma-2B: MQA (kv=1), GeGLU, head_dim=256 [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, mlp_act="geglu", tie_embeddings=True,
    microbatches=2,
))
