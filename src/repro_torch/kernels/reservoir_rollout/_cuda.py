"""Build, load and launch the CUDA rollout kernels (``csrc/rollout.cu``).

The source has a plain C interface, so it is compiled with ``nvcc`` into a
shared library and bound with ``ctypes`` (seconds to build; no PyTorch
headers involved).  Nothing is built when this module is imported: the
first CUDA launch calls :func:`library`, which compiles the source from
the repository into ``build/`` (listed in ``.gitignore``) — keyed by a hash
of the source and flags, so an edited source is rebuilt — and loads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

from repro_torch import obs

__all__ = ["SOURCE", "BUILD_DIR", "NVCC_FLAGS", "library", "build_info",
           "check"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rollout.cu"
# <repo>/build: src/repro_torch/kernels/reservoir_rollout/_cuda.py -> parents[4]
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

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

_LIB: ctypes.CDLL | None = None
_BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA rollout "
                           "kernels are built from source at first use")
    return found


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"librollout_{key}.so"
    t0 = time.perf_counter()
    log = ""
    built = not out.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)      # atomic: concurrent builders never see
        #                           a half-written library
    lib = ctypes.CDLL(str(out))
    for name in ("reservoir_rollout_step", "specialized_rollout_step"):
        fn = getattr(lib, name)
        fn.argtypes = _STEP_ARGTYPES
        fn.restype = ctypes.c_int
    lib.rollout_readout.argtypes = _READOUT_ARGTYPES
    lib.rollout_readout.restype = ctypes.c_int
    _BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                       built=built, log=log)
    obs.event("kernel_build", path=str(out),
              seconds=_BUILD_INFO["seconds"])
    _LIB = lib
    return lib


def build_info() -> dict:
    """Where the library came from, how long building/loading took, and
    nvcc's output (register and shared-memory use per kernel)."""
    return dict(_BUILD_INFO)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
