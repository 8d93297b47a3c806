"""Core library: the paper's contribution as PyTorch/numpy modules.

- ``csd`` / ``bitplanes``: digit recoding and plane decomposition (Secs III/V)
- ``costmodel``: FPGA analytic model (Secs IV-VI)
- ``sparse``: FixedMatrix — offline-compiled fixed sparse matrices
- ``esn`` / ``ridge``: reservoir computing on top of FixedMatrix (Sec II)
- ``spatial``: register-level emulator of the bit-serial multiplier (Sec III)
- ``baselines``: the V100 / SIGMA latency models of Sec. VII
"""
