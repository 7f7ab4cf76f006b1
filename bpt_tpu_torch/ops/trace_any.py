"""K2: occlusion (any hit) over the treelet table (replaces the TPU
kernel bpt_tpu/ops/pallas_sweep.py::trace_any_sweep).

`any_hit` is the wrapper: for tensors on the CPU it runs the plain
PyTorch version, for CUDA tensors it launches the kernel in
bpt_tpu_torch/csrc/any_hit.cu or raises.  `any_hit.launches` counts
kernel launches; `any_hit_plain.cuda_calls` counts calls of the plain
version with CUDA tensors (a comparison harness, never a route).

A segment is occluded when a triangle of a slab-overlapped treelet gives
a hit with t in [min_t, max_t]; dead lanes (max_t < min_t) never are.
"""
from __future__ import annotations

import torch

from . import _build
from .intersect import check_trace_args, moller_trumbore, slab

_PLAIN_CHUNK = 1 << 16


def any_hit_plain(tg, o, d, min_t, max_t):
    """Plain PyTorch any hit: treelet by treelet, the still-open lanes
    that overlap it test its K triangles."""
    if o.is_cuda:
        any_hit_plain.cuda_calls += 1
    b = o.shape[0]
    nt = tg.block.shape[0]
    occ = torch.zeros((b,), dtype=torch.bool, device=o.device)
    if b == 0:
        return occ
    mask, _ = slab(tg.bmin, tg.bmax, o, d, min_t, max_t)
    for j in range(nt):
        act = torch.nonzero(mask[:, j] & ~occ).squeeze(1)
        for s in range(0, act.numel(), _PLAIN_CHUNK):
            a = act[s:s + _PLAIN_CHUNK]
            ok, tt, _, _ = moller_trumbore(tg.block[j:j + 1], o[a], d[a])
            ok &= (tt >= min_t[a, None]) & (tt <= max_t[a, None])
            occ[a] = ok.any(dim=1)
    return occ


any_hit_plain.cuda_calls = 0


def any_hit(tg, o, d, min_t, max_t):
    """Occlusion flags (B,) bool of segments (B, 3) with (B,) windows."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t)
    if o.device.type == "cpu":
        return any_hit_plain(tg, o, d, min_t, max_t)
    occ = torch.empty((b,), dtype=torch.bool, device=o.device)
    if b == 0:
        return occ
    lib = _build.library()
    err = lib.bpt_any_hit(
        tg.bmin.data_ptr(), tg.bmax.data_ptr(), tg.block.data_ptr(), nt, k,
        o.data_ptr(), d.data_ptr(), min_t.data_ptr(), max_t.data_ptr(), b,
        occ.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"any_hit kernel launch failed: CUDA error {err}")
    any_hit.launches += 1
    return occ


any_hit.launches = 0
