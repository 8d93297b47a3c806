"""DeepSeek-V2 236B: MLA (kv_lora=512) + 2 shared / 160 routed top-6 MoE
[arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=0, vocab_size=102400, block_pattern=("mla",), tie_embeddings=False,
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2),
    mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64, nope_dim=128,
                  v_dim=128),
    microbatches=16,
))
