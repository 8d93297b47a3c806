"""Qwen3-32B: dense GQA (kv=8) with qk_norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    tie_embeddings=False,
    microbatches=16,
))
