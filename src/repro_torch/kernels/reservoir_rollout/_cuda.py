"""The CUDA rollout kernels' library (``csrc/rollout.cu``) and the ctypes
signatures of its entry points; :mod:`repro_torch.kernels._build` builds
it at the first CUDA launch."""

from __future__ import annotations

import ctypes
import pathlib

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels._launch import COMMON_HEADER

__all__ = ["LIBRARY"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_RUN_ARGTYPES = [
    _I,                      # int8_mode
    _P, _L, _L,              # u, its T and B strides
    _P, _P, _P,              # w_in, w_out, x0
    _P, _P, _P,              # states, preds, final_state
    _P, _P, _P,              # xbuf, xkeep, partial (scratch)
    _P, _P,                  # blob, blk_meta
    _I, _I, _I, _I, _I,      # steps, batch, dim, in_dim, out_dim
    _I, _I, _I, _I,          # bk, cw, slices, b_tile
    _I, _I, _I, _I,          # readout_every, ldx, rpad, resident
    _I, _I,                  # n_blocks, smem
    _F, _F, _F, _F,          # one_minus_leak, leak, smax, recur_scale
    _P,                      # stream
]
_READOUT_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _I, _P]

LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "rollout.cu",
    {"rollout_run": _RUN_ARGTYPES,
     "rollout_occupancy": [_I, _I, ctypes.POINTER(_I)],
     "rollout_readout": _READOUT_ARGTYPES},
    headers=(COMMON_HEADER,))
