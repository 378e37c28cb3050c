"""Build and bind the port's CUDA sources (csrc/*.cu): nvcc for sm_90a into
a shared library with a plain C interface under the git-ignored
``build/``, loaded with ctypes at the first launch. Each source is one
library; the build is skipped while the library is newer than its source.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# --fmad=false: every product and sum rounds on its own, in the plain
# PyTorch versions' association order, so kernel and plain agree bit for
# bit. -Xptxas -v: registers and spills per kernel, kept in ``build_log``.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]


class CudaLibrary:
    """One csrc/<name>.cu built into build/lib<name>.so; ``load()``
    returns the C function ``symbol`` with ``argtypes`` set and restype
    int (the launch's cudaGetLastError()); ``function`` another C function
    of the same library."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.source = os.path.join(CSRC, name + ".cu")
        self.path = os.path.join(BUILD_DIR, f"lib{name}.so")
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.build_log = ""
        self._dll = None
        self._fns = {}
        self._lock = threading.Lock()

    def load(self):
        return self.function(self.symbol, self.argtypes)

    def function(self, symbol: str, argtypes):
        with self._lock:
            if self._dll is None:
                if not (os.path.exists(self.path) and os.path.getmtime(
                        self.path) >= os.path.getmtime(self.source)):
                    self.build_log = self._build()
                self._dll = ctypes.CDLL(self.path)
            if symbol not in self._fns:
                fn = getattr(self._dll, symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = list(argtypes)
                self._fns[symbol] = fn
            return self._fns[symbol]

    def _build(self) -> str:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, self.source],
                                 check=True, capture_output=True, text=True,
                                 timeout=600)
            os.replace(tmp, self.path)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return res.stderr


def check_tensors(what: str, device, checks) -> None:
    """Raise unless every (tensor, dtype, shape) lies contiguous on
    ``device`` with that dtype and shape."""
    for t, dtype, shape in checks:
        if t.device != device or t.dtype != dtype \
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{what}: want {dtype} {tuple(shape)} contiguous on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
