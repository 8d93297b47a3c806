"""Core library: the paper's contribution as PyTorch/numpy modules.

- ``csd`` / ``bitplanes``: digit recoding and plane decomposition (Secs III/V)
- ``costmodel``: FPGA analytic model (Secs IV-VI)
- ``sparse``: FixedMatrix — offline-compiled fixed sparse matrices
- ``esn`` / ``ridge``: reservoir computing on top of FixedMatrix (Sec II)
"""
