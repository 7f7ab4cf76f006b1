"""Build and load the port's CUDA kernels.

The sources under `bpt_tpu_torch/csrc/` are compiled at first use by nvcc,
one process per source, all started together, and linked into one
shared library with a plain C interface, which is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -Xptxas -v -c csrc/<source>.cu -o <source>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> *.o

`-fmad=false` keeps every multiply and add separately rounded, so each
kernel agrees bit for bit with its plain PyTorch version.  The library
lands in `bpt_tpu_torch/_build/` (git-ignored) under a name carrying the
hash of the sources, the shared header and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .. import telemetry

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("closest_hit.cu", "any_hit.cu", "closest_hit_stream.cu",
           "any_hit_stream.cu", "closest_hit_full.cu",
           "closest_hit_sweep.cu", "any_hit_compact.cu",
           "gather_backward.cu", "threefry.cu")
HEADERS = ("intersect.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# The kernels that read the (NT, 9, K) block (K5, K6 and K7 before their
# redesign, which probes/k5_old_vs_new.py and k67_old_vs_new.py build):
# bmin, bmax, block, tri_index, nt, k, o, d, min_t, max_t, b,
# t, tri, u, v, stream
_CLOSEST = (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P)
# bmin, bmax, block, nt, k, o, d, min_t, max_t, b, occ, stream
_ANY = (_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P)
# The kernels that read the packed rows (accel/treelets.py::
# packed_triangles): K1, K5 and K6, K2 and K7.
# bmin, bmax, rows, offsets, nt, n_rows, o, d, min_t, max_t, b,
# t, tri, u, v, counter, stream
_CLOSEST_PACKED = (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                   _P, _P, _P)
# bmin, bmax, rows, offsets, nt, n_rows, o, d, min_t, max_t, b, occ,
# counter, stream
_ANY_PACKED = (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P)
_SIGNATURES = {
    "bpt_closest_hit": _CLOSEST_PACKED,
    "bpt_closest_hit_full": _CLOSEST_PACKED,
    "bpt_closest_hit_sweep": _CLOSEST_PACKED,
    "bpt_any_hit": _ANY_PACKED,
    "bpt_any_hit_compact": _ANY_PACKED,
    # bmin, bmax, gmin, gmax, rows, counts, tri_index, nt, ng, g, k, o, d,
    # min_t, max_t, b, t, tri, u, v, counter, stream
    "bpt_closest_hit_stream": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P),
    # bmin, bmax, gmin, gmax, rows, counts, nt, ng, g, k, o, d, min_t,
    # max_t, b, occ, counter, stream
    "bpt_any_hit_stream": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                           _P, _P, _I, _P, _P, _P),
    # ids, ids_64, n, m, n_tables, grads (array of pointers), cols (int
    # array), blocks, partials, out, stream
    "bpt_gather_rows_backward": (_P, _I, _I, _I, _I, _P, _P, _I, _P, _P,
                                 _P),
    # mode, keys, data, data_kind, tag, n, dims, geometry (int64 array),
    # out, stream
    "bpt_threefry": (_I, _P, _P, _I, ctypes.c_uint, ctypes.c_longlong, _I,
                     _P, _P, _P),
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
        self.error_string = self._dll.bpt_cuda_error_string
        self.error_string.argtypes = [ctypes.c_int]
        self.error_string.restype = ctypes.c_char_p


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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> str:
    """Wait for nvcc processes; raise with their output if one failed."""
    log = ""
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {proc.returncode}")
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n" + log)
    return log


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _compile_and_link(out: Path) -> str:
    """One nvcc per source, all at once, then one link into `out`."""
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    tmp.mkdir()
    try:
        objs = [tmp / (Path(s).stem + ".o") for s in SOURCES]
        log = _run([_start([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o",
                            str(o)]) for s, o in zip(SOURCES, objs)])
        lib = tmp / out.name
        log += _run([_start([nvcc, *ARCH, "-shared", "-o", str(lib),
                             *map(str, objs)])])
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return log


def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    global _library
    if _library is not None:
        return _library
    with telemetry.timed("setup.kernel_library_s"):
        out = BUILD_DIR / f"libbpt_kernels_{_digest()}.so"
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            log = _compile_and_link(out)
        _library = KernelLibrary(out, log)
    return _library


def launch(name: str, device, *args) -> None:
    """Launch kernel entry point `name` of the library on `device`'s
    current stream; raise if CUDA refused the launch (too many threads,
    or more shared memory than the card grants a block)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = library()
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
