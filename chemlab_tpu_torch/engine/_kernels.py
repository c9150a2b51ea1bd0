"""Build and load the hand-written CUDA kernels (route: nvcc + ctypes).

Each ``csrc/*.cu`` file exposes a plain C function that launches its
kernel on the stream it is given and returns ``cudaGetLastError()``.  At
first use the source is compiled by ``nvcc`` for ``sm_90a`` into
``chemlab_tpu_torch/_build/`` (named by a hash of the source and flags, so
an edited source rebuilds) and loaded with ``ctypes``.  Nothing is built or
loaded when this module is imported: the CPU tests import every module.

Flags: ``--fmad=false`` keeps ``a*b + c`` as two rounded operations, the
op sequence of the torch correction the kernel's sum must cancel against;
no fast-math flag, so division and ``rintf`` stay IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def nvcc_command(nvcc: str, source: Path, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source)]


class CudaKernel:
    """One kernel: its source, its C entry point and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / ("lib%s-%s.so" % (self.source.stem,
                                             h.hexdigest()[:16]))

    def build(self) -> float:
        """Compile if the library is missing; returns the seconds spent."""
        lib = self.library_path()
        if lib.exists():
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(".tmp%d.so" % os.getpid())
        t0 = time.perf_counter()
        proc = subprocess.run(nvcc_command(find_nvcc(), self.source, tmp),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s%s" % (
                self.source.name, proc.stdout, proc.stderr))
        os.replace(tmp, lib)
        return time.perf_counter() - t0

    def function(self):
        if self._fn is None:
            self.build()
            fn = getattr(ctypes.CDLL(str(self.library_path())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args):
        """Launch once; raises if the launch was refused."""
        rc = self.function()(*args)
        if rc != 0:
            raise RuntimeError("%s launch failed: cudaError %d"
                               % (self.symbol, rc))
        self.launches += 1
