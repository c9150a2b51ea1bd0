"""Build and load the hand-written CUDA kernels (route: nvcc + ctypes).

Each ``csrc/*.cu`` file exposes plain C functions that launch its kernel
on the stream they are given and return ``cudaGetLastError()``.  At first
use the source is compiled by ``nvcc`` for ``sm_90a`` into
``chemlab_tpu_torch/_build/`` (named by a hash of the source, the headers
it includes and the flags, so an edited source or header rebuilds) and
loaded with ``ctypes``; ``build_all`` compiles several sources at once, one
``nvcc`` each.  Nothing is built or
loaded when this module is imported: the CPU tests import every module.

Flags: ``--fmad=false`` keeps ``a*b + c`` as two rounded operations, the
op sequence of the torch correction the kernel's sum must cancel against;
no fast-math flag, so division, ``sqrtf`` and ``rintf`` stay IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


# a header of csrc/ included by a quoted name
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


def source_files(source: Path) -> list:
    """``source`` and every header it includes by a quoted name, directly or
    through another header, in the order first included."""
    out = [source]
    for path in out:
        for name in _INCLUDE.findall(path.read_text()):
            header = path.parent / name
            if header not in out:
                out.append(header)
    return out


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
        h = hashlib.sha256()
        for path in source_files(self.source):
            h.update(path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / ("lib%s-%s.so" % (self.source.stem,
                                             h.hexdigest()[:16]))

    def build(self) -> float:
        """Compile if the library is missing; returns the seconds spent."""
        return build_all([self])

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


def build_all(kernels) -> float:
    """Compile every missing library among ``kernels``, one ``nvcc`` per
    source, all started together; returns the seconds spent."""
    todo = {}
    for k in kernels:
        lib = k.library_path()
        if not lib.exists():
            todo[lib] = k.source
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for lib, source in todo.items():
        tmp = lib.with_suffix(".tmp%d.so" % os.getpid())
        procs.append((lib, tmp, source, subprocess.Popen(
            nvcc_command(nvcc, source, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for lib, tmp, source, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("nvcc failed for %s:\n%s" % (source.name, log))
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0
