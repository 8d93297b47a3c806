"""StableLM-2-1.6B: dense MHA, LayerNorm, 25% partial rotary
[hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352, norm="layernorm", rope_fraction=0.25,
    tie_embeddings=False,
    microbatches=2,
))
