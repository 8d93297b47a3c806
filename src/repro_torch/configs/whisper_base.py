"""Whisper-base: enc-dec, conv frontend stubbed to precomputed frame
embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import EncoderConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865, mlp_act="gelu", norm="layernorm",
    encoder=EncoderConfig(n_layers=6, seq_len=1500), frontend="audio",
    tie_embeddings=True,
    microbatches=8,
))
