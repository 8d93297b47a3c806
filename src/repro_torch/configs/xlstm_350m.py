"""xLSTM-350M: mLSTM matrix-memory blocks with interleaved sLSTM
[arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"), tie_embeddings=True,
    microbatches=4,
))
