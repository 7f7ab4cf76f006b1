"""K2, K4 and K7: occlusion (any hit) over the treelet table.

K2 (`any_hit`, kernel bpt_tpu_torch/csrc/any_hit.cu) replaces the TPU
kernel bpt_tpu/ops/pallas_sweep.py::trace_any_sweep and takes tables of
at most MAX_TREELETS treelets.  K4 (`any_hit_stream`, kernel
bpt_tpu_torch/csrc/any_hit_stream.cu) replaces
bpt_tpu/ops/pallas_sweep.py::trace_any_stream: the same flags on tables
of any size, with the table taken in groups of `chunk_nt` consecutive
treelets behind their union boxes (accel/treelets.py::group_boxes).
K7 (`any_hit_compact`, csrc/any_hit_compact.cu) replaces
bpt_tpu/ops/pallas_trace.py::trace_any_compact: the same flags, with
each tile of 128 lanes testing only the union of the treelets its lanes
overlap, listed in shared memory.

Each wrapper runs its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors, or raises.  `<wrapper>.launches`
counts kernel launches; `<plain>.cuda_calls` counts calls of a plain
version with CUDA tensors (a comparison harness, never a route).

A segment is occluded when a triangle of a slab-overlapped treelet gives
a hit with t in [min_t, max_t]; dead lanes (max_t < min_t) never are.
"""
from __future__ import annotations

import torch

from . import _build
from ..accel.treelets import (group_boxes, packed_triangles, triangle_counts,
                              triangle_rows)
from .intersect import SLAB_ELEMS, check_trace_args, moller_trumbore, slab

# (segment, treelet) pairs per triangle-test step of the plain versions.
_PLAIN_CHUNK = 1 << 16


def _any_chunks(tg, o, d, min_t, max_t, chunk_nt):
    """The plain occlusion test, chunk by chunk in index order: a lane
    settled in one chunk skips the later ones.  Temporaries are at most
    (SLAB_ELEMS / chunk_nt lanes, chunk_nt)."""
    b = o.shape[0]
    nt = tg.block.shape[0]
    occ = torch.zeros((b,), dtype=torch.bool, device=o.device)
    open_ = torch.nonzero(max_t >= min_t).squeeze(1)
    lanes = max(1, SLAB_ELEMS // chunk_nt)
    for c0 in range(0, nt, chunk_nt):
        if open_.numel() == 0:
            break
        c1 = min(c0 + chunk_nt, nt)
        hits = torch.zeros(open_.shape, dtype=torch.int32, device=o.device)
        for s0 in range(0, open_.numel(), lanes):
            ln = open_[s0:s0 + lanes]
            mask, _ = slab(tg.bmin[c0:c1], tg.bmax[c0:c1], o[ln], d[ln],
                           min_t[ln], max_t[ln])
            li, lj = torch.nonzero(mask, as_tuple=True)
            del mask
            for s in range(0, li.numel(), _PLAIN_CHUNK):
                pi, pj = li[s:s + _PLAIN_CHUNK], lj[s:s + _PLAIN_CHUNK]
                a = ln[pi]
                ok, tt, _, _ = moller_trumbore(tg.block[pj + c0], o[a], d[a])
                ok &= (tt >= min_t[a, None]) & (tt <= max_t[a, None])
                hits.index_add_(0, pi + s0, ok.any(dim=1).to(torch.int32))
        settled = hits > 0
        occ[open_[settled]] = True
        open_ = open_[~settled]
    return occ


def any_hit_plain(tg, o, d, min_t, max_t):
    """Plain PyTorch version of K2: the whole table as one chunk."""
    if o.is_cuda:
        any_hit_plain.cuda_calls += 1
    return _any_chunks(tg, o, d, min_t, max_t, max(tg.block.shape[0], 1))


any_hit_plain.cuda_calls = 0


def any_hit_stream_plain(tg, o, d, min_t, max_t, chunk_nt):
    """Plain PyTorch version of K4: chunks of `chunk_nt` treelets."""
    if o.is_cuda:
        any_hit_stream_plain.cuda_calls += 1
    return _any_chunks(tg, o, d, min_t, max_t, chunk_nt)


any_hit_stream_plain.cuda_calls = 0


def any_hit_compact_plain(tg, o, d, min_t, max_t):
    """Plain PyTorch version of K7.  The flags do not depend on the order
    in which treelets are tested, so this is K2's function: the whole
    table as one chunk."""
    if o.is_cuda:
        any_hit_compact_plain.cuda_calls += 1
    return _any_chunks(tg, o, d, min_t, max_t, max(tg.block.shape[0], 1))


any_hit_compact_plain.cuda_calls = 0


def _launch_packed(name, tg, o, d, min_t, max_t, b, nt):
    """Launch an any-hit kernel that reads the table's boxes and its
    packed triangles (accel/treelets.py::packed_triangles): K2, K7."""
    rows, offsets = packed_triangles(tg)
    occ = torch.empty((b,), dtype=torch.bool, device=o.device)
    counter = torch.zeros((1,), dtype=torch.int32, device=o.device)
    _build.launch(name, o.device, tg.bmin.data_ptr(), tg.bmax.data_ptr(),
                  rows.data_ptr(), offsets.data_ptr(), nt, rows.shape[0],
                  o.data_ptr(), d.data_ptr(), min_t.data_ptr(),
                  max_t.data_ptr(), b, occ.data_ptr(), counter.data_ptr())
    return occ


def any_hit(tg, o, d, min_t, max_t):
    """K2: occlusion flags (B,) bool of segments (B, 3) with (B,) windows
    against a table of at most MAX_TREELETS treelets."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t)
    if o.device.type == "cpu":
        return any_hit_plain(tg, o, d, min_t, max_t)
    if b == 0:
        return torch.empty((0,), dtype=torch.bool, device=o.device)
    occ = _launch_packed("bpt_any_hit", tg, o, d, min_t, max_t, b, nt)
    any_hit.launches += 1
    return occ


any_hit.launches = 0


def any_hit_stream(tg, o, d, min_t, max_t, chunk_nt):
    """K4: occlusion flags (B,) bool against a table of any size, taken in
    groups of `chunk_nt` (1..MAX_TREELETS) treelets.  Raises if the card
    cannot hold the group boxes in one block's shared memory."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t, chunk_nt)
    if o.device.type == "cpu":
        return any_hit_stream_plain(tg, o, d, min_t, max_t, chunk_nt)
    occ = torch.empty((b,), dtype=torch.bool, device=o.device)
    if b == 0:
        return occ
    gmin, gmax = group_boxes(tg, chunk_nt)
    counter = torch.zeros((1,), dtype=torch.int32, device=o.device)
    _build.launch("bpt_any_hit_stream", o.device, tg.bmin.data_ptr(),
                  tg.bmax.data_ptr(), gmin.data_ptr(), gmax.data_ptr(),
                  triangle_rows(tg).data_ptr(),
                  triangle_counts(tg).data_ptr(), nt, gmin.shape[0],
                  chunk_nt, k, o.data_ptr(), d.data_ptr(), min_t.data_ptr(),
                  max_t.data_ptr(), b, occ.data_ptr(), counter.data_ptr())
    any_hit_stream.launches += 1
    return occ


any_hit_stream.launches = 0


def any_hit_compact(tg, o, d, min_t, max_t):
    """K7, the counterpart of the TPU kernel trace_any_compact: occlusion
    flags (B,) bool, equal to K2's, computed by tiles of lanes over the
    union of their treelets.  At most MAX_TREELETS treelets."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t)
    if o.device.type == "cpu":
        return any_hit_compact_plain(tg, o, d, min_t, max_t)
    if b == 0:
        return torch.empty((0,), dtype=torch.bool, device=o.device)
    occ = _launch_packed("bpt_any_hit_compact", tg, o, d, min_t, max_t, b,
                         nt)
    any_hit_compact.launches += 1
    return occ


any_hit_compact.launches = 0
