"""Build and load the port's CUDA kernels.

The sources under `bpt_tpu_torch/csrc/` are compiled at first use by nvcc
into one shared library with a plain C interface, which is loaded with
ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/*.cu

`-fmad=false` keeps every multiply and add separately rounded, so each
kernel agrees bit for bit with its plain PyTorch version.  The library
lands in `bpt_tpu_torch/_build/` (git-ignored) under a name carrying the
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("closest_hit.cu", "any_hit.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # bmin, bmax, block, tri_index, nt, k, o, d, min_t, max_t, b,
    # t, tri, u, v, stream
    "bpt_closest_hit": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                        _P, _P, _P, _P, _P),
    # bmin, bmax, block, nt, k, o, d, min_t, max_t, b, occ, stream
    "bpt_any_hit": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P),
}


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, path: Path, log: str):
        self.path = path
        self.build_log = log
        self._dll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._dll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


_library = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of bpt_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    global _library
    if _library is not None:
        return _library
    out = BUILD_DIR / f"libbpt_kernels_{_digest()}.so"
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    _library = KernelLibrary(out, log)
    return _library
