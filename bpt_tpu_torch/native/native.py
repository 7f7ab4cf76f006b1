"""The native (C++) BVH builder, built by the host compiler at first use
and loaded with ctypes (port of bpt_tpu/native/native.py).

`bvh_builder.cpp` is a copy of the reference package's source.  It
builds exactly the numpy builder's midpoint tree
(`accel/build.py::build_bvh_numpy`), in a fraction of its time on large
meshes:

    g++ -O3 -fPIC -std=c++17 -Wall -shared bvh_builder.cpp -o <lib>

The library lands in `bpt_tpu_torch/_build/` (git-ignored) under a name
carrying the hash of the source, the flags and the compiler's version,
built in a directory of its own process and moved into place, so
processes that build at once do not race.  The reference's Makefile adds
-march=native; it is left out because a build directory may be copied
to another machine.  Without a compiler the build raises: there is no
quiet fallback to the numpy builder.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "bvh_builder.cpp"
BUILD_DIR = HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_library = None
# The C++ side keeps the last tree in one global between build and export.
_lock = threading.Lock()


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("no C++ compiler (g++) found: the native BVH "
                           "builder of bpt_tpu_torch is built from "
                           "bpt_tpu_torch/native/bvh_builder.cpp at first "
                           "use")
    return path


def _digest(cxx: str) -> str:
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(version.encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def _build(cxx: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    tmp.mkdir()
    try:
        lib = tmp / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(lib)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native BVH builder failed "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """Build (if needed) and load the builder's library."""
    global _library
    with _lock:
        if _library is None:
            cxx = _cxx()
            out = BUILD_DIR / f"libbpt_native_{_digest(cxx)}.so"
            if not out.exists():
                _build(cxx, out)
            lib = ctypes.CDLL(str(out))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.bpt_bvh_build.restype = ctypes.c_int64
            lib.bpt_bvh_build.argtypes = [ctypes.c_int64, f32p, f32p, f32p]
            lib.bpt_bvh_export.restype = None
            lib.bpt_bvh_export.argtypes = [f32p, f32p, i32p, i32p, i32p,
                                           i32p]
            lib.bpt_bvh_free.restype = None
            lib.bpt_bvh_free.argtypes = []
            _library = lib
    return _library


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """The midpoint BVH over (T, 3) vertex arrays, built in C++: the
    arrays of accel/build.py's FlatBVH (bmin, bmax, miss, start, count,
    prim_order)."""
    lib = library()
    t = v0.shape[0]
    for a in (v0, v1, v2):
        if a.shape != (t, 3):
            raise ValueError(f"vertex arrays must be (T, 3), got {a.shape}")
    v0, v1, v2 = (np.ascontiguousarray(a, np.float32) for a in (v0, v1, v2))
    with _lock:
        n = int(lib.bpt_bvh_build(t, v0, v1, v2))
        bmin = np.empty((n, 3), np.float32)
        bmax = np.empty((n, 3), np.float32)
        miss = np.empty(n, np.int32)
        start = np.empty(n, np.int32)
        count = np.empty(n, np.int32)
        prim_order = np.empty(t, np.int32)
        lib.bpt_bvh_export(bmin, bmax, miss, start, count, prim_order)
        lib.bpt_bvh_free()
    return bmin, bmax, miss, start, count, prim_order
