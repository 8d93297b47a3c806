"""InternVL2-76B: InternViT frontend (stubbed patch embeddings) + 80-layer
LLaMA-family backbone [arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, rope_theta=5e5, frontend="vision",
    tie_embeddings=False,
    microbatches=32,
))
