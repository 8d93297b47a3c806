"""The CUDA rollout kernels' library (``csrc/rollout.cu``) and the ctypes
signatures of its entry points; :mod:`repro_torch.kernels._build` builds
it at the first CUDA launch."""

from __future__ import annotations

import ctypes
import pathlib

from repro_torch.kernels._build import CudaLibrary

__all__ = ["LIBRARY"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STEP_ARGTYPES = [
    _I,                      # int8_mode
    _P, _I, _P, _I, _P, _I,  # x_prev, ld, x_next, ld, x_copy, ld
    _P, _I, _P,              # u_t, ld_u, w_in
    _P, _P, _P, _P,          # tiles, col_ptr, terms, digits
    _I, _I, _I, _I, _I,      # batch, dim, in_dim, bk, cw (column slice)
    _I, _I,                  # n_col_blocks, b_tile
    _F, _F, _F, _F,          # one_minus_leak, leak, smax, recur_scale
    _P,                      # stream
]
_READOUT_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _I, _P]

LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "rollout.cu",
    {"reservoir_rollout_step": _STEP_ARGTYPES,
     "specialized_rollout_step": _STEP_ARGTYPES,
     "rollout_readout": _READOUT_ARGTYPES})
