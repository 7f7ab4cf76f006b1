"""Threefry-2x32 on the card: `core/rng.py`'s `fold_in`, `uniform1` and
`uniform2` for CUDA tensors, each one launch of the kernel of
bpt_tpu_torch/csrc/threefry.cu.

The functions here take and return what the plain versions in
`core/rng.py` do, bit for bit: (..., 2) int64 keys holding two uint32
words, integer data cut to its low 32 bits, float32 uniforms.  Keys and
per-lane data are read through their strides, so a broadcast (a (1, 2) key
against (B,) ids, (S, 1, 2) keys against (1, P) ids) costs no copy; a
scalar tag travels as a kernel argument.  Outputs are allocated with
`torch.empty` (PyTorch's caching allocator) and the kernel launches on the
current stream with no host sync, so a call can be captured in a CUDA
graph.  Nothing here decides between the kernel and the plain version:
`core/rng.py` routes by the keys' device.

`threefry_cuda.launches` counts the kernel's launches (one a call with
lanes, none without); the counter `rng.calls.kernel` adds one a call while
a profiler runs.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .. import telemetry

FOLD_IN, UNIFORM1, UNIFORM2 = 0, 1, 2
# The kernel's index space: at most MAX_DIMS broadcast dimensions; a call
# with more is flattened into one first.
MAX_DIMS = 4
_MASK = 0xFFFFFFFF
_KIND = {torch.int32: 1, torch.int64: 2}


def threefry_cuda(mode, keys, shape, out, data=None, tag=0):
    """Launch the kernel: `keys` (..., 2) int64 broadcast to `shape` + (2,),
    `data` an int32 or int64 tensor broadcast to `shape` (FOLD_IN only; a
    scalar `tag` without it), `out` contiguous of `shape` lanes."""
    n = 1
    for s in shape:
        n *= s
    if n == 0:
        return out
    if len(shape) > MAX_DIMS:
        keys = keys.expand(*shape, 2).reshape(n, 2)
        data = None if data is None else data.expand(shape).reshape(n)
        shape = (n,)
    kst = keys.stride()
    geometry = (*shape, *_aligned(keys.shape[:-1], kst[:-1], shape),
                *(_aligned(data.shape, data.stride(), shape) if data is not
                  None else (0,) * len(shape)), kst[-1])
    _build.launch("bpt_threefry", keys.device, mode, keys.data_ptr(),
                  None if data is None else data.data_ptr(),
                  0 if data is None else _KIND[data.dtype], tag, n,
                  len(shape), (ctypes.c_longlong * len(geometry))(*geometry),
                  out.data_ptr())
    threefry_cuda.launches += 1
    return out


threefry_cuda.launches = 0


def _aligned(shape, strides, out):
    """The strides of a tensor of `shape` broadcast to `out` (aligned at
    the right): 0 along the dimensions it is broadcast over."""
    pad = len(out) - len(shape)
    return (0,) * pad + tuple(0 if s == 1 else st
                              for s, st in zip(shape, strides))


def _broadcast(a, b):
    """torch.broadcast_shapes of two shapes, in plain Python."""
    pad = len(a) - len(b)
    a, b = (1,) * -pad + tuple(a), (1,) * pad + tuple(b)
    for x, y in zip(a, b):
        if x != y and x != 1 and y != 1:
            raise ValueError(f"shapes {a} and {b} do not broadcast")
    return tuple(y if x == 1 else x for x, y in zip(a, b))


def _check_keys(keys):
    if keys.dtype != torch.int64 or keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be (..., 2) int64, got {keys.dtype} "
                         f"{tuple(keys.shape)}")


def fold_in(keys, data):
    """`rng.fold_in` on CUDA keys: `data` an int, a 0-dim tensor or an
    integer tensor on the keys' device broadcastable against keys[..., 0]."""
    telemetry.add("rng.calls.kernel", 1)
    _check_keys(keys)
    if torch.is_tensor(data) and data.dim() == 0 and not data.is_cuda:
        data = int(data)
    if not torch.is_tensor(data):
        shape = keys.shape[:-1]
        return threefry_cuda(FOLD_IN, keys, shape,
                             torch.empty((*shape, 2), dtype=torch.int64,
                                         device=keys.device),
                             tag=int(data) & _MASK)
    if data.device != keys.device:
        raise ValueError(f"the data is on {data.device}, the keys on "
                         f"{keys.device}")
    if data.dtype not in _KIND:
        data = data.to(torch.int64)
    shape = _broadcast(keys.shape[:-1], data.shape)
    return threefry_cuda(FOLD_IN, keys, shape,
                         torch.empty((*shape, 2), dtype=torch.int64,
                                     device=keys.device), data=data)


def uniform1(keys):
    """`rng.uniform1` on CUDA keys: (...) float32."""
    telemetry.add("rng.calls.kernel", 1)
    _check_keys(keys)
    shape = keys.shape[:-1]
    return threefry_cuda(UNIFORM1, keys, shape,
                         torch.empty(shape, dtype=torch.float32,
                                     device=keys.device))


def uniform2(keys):
    """`rng.uniform2` on CUDA keys: (..., 2) float32."""
    telemetry.add("rng.calls.kernel", 1)
    _check_keys(keys)
    shape = keys.shape[:-1]
    return threefry_cuda(UNIFORM2, keys, shape,
                         torch.empty((*shape, 2), dtype=torch.float32,
                                     device=keys.device))
