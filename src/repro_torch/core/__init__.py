"""Core library: the paper's contribution as PyTorch/numpy modules.

- ``csd`` / ``bitplanes``: digit recoding and plane decomposition (Secs III/V)
- ``costmodel``: FPGA analytic model (Secs IV-VI)
- ``sparse``: FixedMatrix — offline-compiled fixed sparse matrices
- ``esn`` / ``ridge``: reservoir computing on top of FixedMatrix (Sec II)
- ``spatial``: register-level emulator of the bit-serial multiplier (Sec III)
- ``baselines``: the V100 / SIGMA latency models of Sec. VII
"""

from repro_torch.core.bitplanes import (DigitPlanes, decompose,  # noqa: F401
                                        pn_split)
from repro_torch.core.costmodel import (design_point,  # noqa: F401
                                        expected_ones)
from repro_torch.core.csd import convert_to_csd, csd_transform  # noqa: F401
from repro_torch.core.esn import (ESNConfig, init_esn,  # noqa: F401
                                  run_reservoir)
from repro_torch.core.sparse import BlockSparse, FixedMatrix  # noqa: F401
