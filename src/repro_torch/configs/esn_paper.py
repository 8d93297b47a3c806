"""The paper's own workload: fixed sparse reservoirs (Sec. II/VI).

Dims/sparsities follow Sec. VI (512 and 1024, 40-98% element sparsity,
8-bit signed weights) — the same configurations as the JAX package's.
"""
from repro_torch.core.esn import ESNConfig

PAPER_BASELINE = ESNConfig(reservoir_dim=800, element_sparsity=0.75)  # [5]
LARGE_512 = ESNConfig(reservoir_dim=512, element_sparsity=0.90,
                      mode="int8-csd")
LARGE_1024 = ESNConfig(reservoir_dim=1024, element_sparsity=0.95,
                       mode="int8-csd")
