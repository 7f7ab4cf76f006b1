"""Occlusion (any hit) over the treelet table, in plain PyTorch.

A frozen copy of the plain version of K2 in bpt_tpu_torch/ops/
trace_any.py (`_any_chunks` over the whole table as one chunk).  A
segment is occluded when a triangle of a slab-overlapped treelet gives a
hit with t in [min_t, max_t]; dead lanes (max_t < min_t) never are.
"""
from __future__ import annotations

import torch

from .intersect import SLAB_ELEMS, moller_trumbore, slab

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


def any_hit(tg, o, d, min_t, max_t):
    """(B,) occlusion flags against the whole table."""
    return _any_chunks(tg, o, d, min_t, max_t, max(tg.block.shape[0], 1))
