"""Build and load one kernel package's CUDA source (nvcc + ctypes).

Every kernel source has a plain C interface, so it is compiled with
``nvcc`` into a shared library and bound with ``ctypes`` (seconds to build;
no PyTorch headers involved).  Nothing is built when a module is imported:
the first CUDA launch of a package calls :meth:`CudaLibrary.load`, which
compiles the source from the repository into ``build/`` (listed in
``.gitignore``) and loads it.  The library's name carries a hash of the
source, the headers it includes and the flags, so an edited source is
rebuilt; the rename into place is atomic, so concurrent builders never see
a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from repro_torch import obs

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "CudaLibrary", "check"]

# <repo>/build: src/repro_torch/kernels/_build.py -> parents[3]
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


class CudaLibrary:
    """One ``csrc/*.cu`` file, compiled on first :meth:`load`.

    ``entries`` maps each exported C function to its ctypes argument types
    (``c_void_p`` for pointers and the stream, ``c_int`` / ``c_float`` for
    scalars); every entry returns a CUDA error code (0 on success).
    ``headers`` are files the source includes: they join the build key.
    """

    def __init__(self, source: pathlib.Path, entries: dict,
                 headers: tuple = ()):
        self.source = pathlib.Path(source)
        self.entries = dict(entries)
        self.headers = tuple(pathlib.Path(h) for h in headers)
        self._lib: ctypes.CDLL | None = None
        self._info: dict = {}
        self._lock = threading.Lock()

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def path(self) -> pathlib.Path:
        """Where the library for the current source and flags lives."""
        blob = self.source.read_bytes()
        for h in self.headers:
            blob += h.read_bytes()
        key = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{key}.so"

    def load(self) -> ctypes.CDLL:
        """The loaded library, compiled first if no build of this source
        exists."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        out = self.path()
        t0 = time.perf_counter()
        log = ""
        built = not out.exists()
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n{log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in self.entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._info = dict(path=str(out), seconds=time.perf_counter() - t0,
                          built=built, log=log)
        obs.event("kernel_build", path=str(out), seconds=self._info["seconds"])
        return lib

    def build_info(self) -> dict:
        """Where the library came from, how long building/loading took, and
        nvcc's output (register and shared-memory use per kernel)."""
        return dict(self._info)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
