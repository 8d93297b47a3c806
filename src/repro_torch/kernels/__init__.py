"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch twin.

- ``reservoir_rollout`` — T-step fused reservoir rollout: the generic
  banded kernel (``reservoir_rollout.reservoir_rollout``, B1), the
  plan-specialized kernel (``specialized.specialized_rollout``, B2) and the
  readout kernel they share.
- ``bitplane_gemv`` — the exact digit-plane product (B3), wrapped by
  ``ops.BitplaneGemv``.
- ``bcsr_matmul`` — the block-sparse product over the culled tile list
  (B4), wrapped by ``ops.BcsrMatmul``.
- ``reservoir_step`` — one fused dense ESN step (B5), wrapped by
  ``ops.FusedReservoir``.

``_build`` compiles each package's ``csrc/*.cu`` at its first CUDA launch;
``_launch`` holds the checks every wrapper makes before a launch.
"""
