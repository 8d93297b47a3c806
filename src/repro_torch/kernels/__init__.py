"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch twin.

- ``reservoir_rollout`` — T-step fused reservoir rollout: the generic
  banded kernel (``reservoir_rollout.reservoir_rollout``), the
  plan-specialized kernel (``specialized.specialized_rollout``) and the
  readout kernel they share.
"""
