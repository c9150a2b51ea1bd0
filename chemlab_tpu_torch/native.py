"""ctypes bindings for the host library ``csrc/chemlab_host.cpp``.

Port of ``chemlab_tpu/native.py``: the same entry points (``available``,
``parse_gro``, ``generate_exclusions``) over the port's own copy of the
C++ source.  It speeds up the host-side data pipeline (large .gro
parsing, the exclusion BFS); it is host code, no device kernel.

At first use the source is compiled with ``g++ -O3 -fPIC -std=c++17
-shared`` into ``chemlab_tpu_torch/_build/``, named by a hash of the
source and the flags (as ``engine/_kernels.py`` names the CUDA
libraries).  Where no ``g++`` exists every entry point returns None and
``available()`` is False, so callers keep their pure-Python paths; where
``g++`` exists and the build fails, the first use raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from .engine._kernels import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "chemlab_host.cpp"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LIB = None
_TRIED = False


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / ("libchemlab_host-%s.so" % h.hexdigest()[:16])


def build():
    """The library's path, compiled if missing; None without ``g++``."""
    lib = library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(".tmp%d.so" % os.getpid())
    out = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError("g++ failed for %s:\n%s" % (SOURCE.name,
                                                       out.stderr))
    os.replace(tmp, lib)
    return lib


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    c64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.parse_gro.restype = ctypes.c_int
    lib.parse_gro.argtypes = [ctypes.c_char_p, ctypes.c_int64, c64p, f64p,
                              f64p, i32p, c64p, c64p, ctypes.c_char_p,
                              ctypes.c_char_p, f64p]
    lib.generate_exclusions.restype = ctypes.c_void_p
    lib.generate_exclusions.argtypes = [c64p, ctypes.c_int64, ctypes.c_int32,
                                        c64p]
    lib.fetch_exclusions.restype = None
    lib.fetch_exclusions.argtypes = [ctypes.c_void_p, c64p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def parse_gro(text: bytes):
    """Parse .gro file bytes -> dict of arrays, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    # upper bound on atom count from the count line; malformed/truncated
    # input returns None so callers fall back to the Python parser's errors
    try:
        nl1 = text.index(b"\n")
        nl2 = text.index(b"\n", nl1 + 1)
        cap = int(text[nl1:nl2].split()[0])
    except (ValueError, IndexError):
        return None
    n = ctypes.c_int64(cap)
    pos = np.zeros((cap, 3), np.float64)
    vel = np.zeros((cap, 3), np.float64)
    has_vel = ctypes.c_int32(0)
    atom_ids = np.zeros(cap, np.int64)
    res_idx = np.zeros(cap, np.int64)
    res_names = ctypes.create_string_buffer(cap * 8)
    atom_names = ctypes.create_string_buffer(cap * 8)
    box = np.zeros(3, np.float64)
    rc = lib.parse_gro(
        text, len(text), ctypes.byref(n),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        vel.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(has_vel),
        atom_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        res_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        res_names, atom_names,
        box.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    nn = n.value
    rn = np.frombuffer(res_names.raw, dtype="S8", count=nn).astype("U8").tolist()
    an = np.frombuffer(atom_names.raw, dtype="S8", count=nn).astype("U8").tolist()
    return {
        "n_atoms": nn,
        "pos": pos[:nn],
        "vel": vel[:nn] if has_vel.value else None,
        "atom_ids": atom_ids[:nn],
        "res_idx": res_idx[:nn],
        "res_names": rn,
        "atom_names": an,
        "box": box,
    }


def generate_exclusions(bonds, nrexcl: int):
    """Exclusion pairs within nrexcl hops; returns a set of (lo, hi) tuples
    or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    arr = np.asarray(list(bonds), np.int64).reshape(-1, 2)
    n_out = ctypes.c_int64(0)
    handle = lib.generate_exclusions(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        arr.shape[0], nrexcl, ctypes.byref(n_out))
    out = np.zeros((n_out.value, 2), np.int64)
    lib.fetch_exclusions(handle,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return set(map(tuple, out.tolist()))
