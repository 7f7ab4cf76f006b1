"""Treelet tables: the host-side treelet cut, the device table, and the
flat BVH triangle arrays the shading code gathers from (a frozen copy of
bpt_tpu_torch/accel/treelets.py without the layouts only the kernels
read).  A treelet is a BVH subtree whose triangles span a contiguous
BVH-order range of at most K.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .build import FlatBVH


class TraceGeom(NamedTuple):
    """Triangles in BVH order, padded by LEAF_SIZE degenerate triangles,
    plus the threaded BVH node arrays."""

    v0: torch.Tensor          # (T+pad, 3)
    e1: torch.Tensor          # (T+pad, 3)  v1 - v0
    e2: torch.Tensor          # (T+pad, 3)  v2 - v0
    node_bmin: torch.Tensor   # (N, 3)
    node_bmax: torch.Tensor   # (N, 3)
    node_miss: torch.Tensor   # (N,)
    node_start: torch.Tensor  # (N,)
    node_count: torch.Tensor  # (N,)


class TreeletGeom(NamedTuple):
    """Treelet table: NT boxes of up to K contiguous BVH-order triangles.
    The triangle block packs (v0xyz, e1xyz, e2xyz) as (NT, 9, K) f32; pad
    slots are degenerate (all zero) and index the pad triangle T."""

    bmin: torch.Tensor       # (NT, 3)
    bmax: torch.Tensor       # (NT, 3)
    tri_index: torch.Tensor  # (NT, K) i32
    block: torch.Tensor      # (NT, 9, K) f32


class Treelets(NamedTuple):
    """Host-side treelet arrays (numpy); converted to device arrays by
    `make_treelet_geom`."""

    bmin: np.ndarray       # (NT, 3)
    bmax: np.ndarray       # (NT, 3)
    tri_index: np.ndarray  # (NT, K) BVH-order triangle id (pad slot = T)
    v0: np.ndarray         # (NT, K, 3)
    e1: np.ndarray         # (NT, K, 3)
    e2: np.ndarray         # (NT, K, 3)


def build_treelets(bvh: FlatBVH, v0r: np.ndarray, e1: np.ndarray,
                   e2: np.ndarray, k: int) -> Treelets:
    """Cut the flat BVH into treelets of <= k contiguous triangles.

    v0r/e1/e2 are the BVH-ordered triangle arrays (unpadded, length T).
    The pad triangle id is T (callers pad their triangle tables by at
    least one degenerate triangle).
    """
    n = bvh.n_nodes
    t = len(v0r)
    # Subtree primitive count: prefix sums of leaf counts over the
    # preorder interval [i, miss[i]).
    s = np.zeros(n + 1, np.int64)
    np.cumsum(bvh.count, out=s[1:])
    sub_count = s[bvh.miss] - s[np.arange(n)]

    cuts = []
    i = 0
    while i < n:
        if sub_count[i] <= k or bvh.count[i] > 0:
            cuts.append(i)
            i = int(bvh.miss[i])
        else:
            i += 1

    nt = len(cuts)
    bmin = bvh.bmin[cuts].copy()
    bmax = bvh.bmax[cuts].copy()
    tri_index = np.full((nt, k), t, np.int32)
    tv0 = np.zeros((nt, k, 3), np.float32)
    te1 = np.zeros((nt, k, 3), np.float32)
    te2 = np.zeros((nt, k, 3), np.float32)

    for j, node in enumerate(cuts):
        # The subtree's leaves are the nodes in [node, miss[node]) with
        # count > 0; their (start, count) ranges are contiguous.
        leaves = np.arange(node, int(bvh.miss[node]))
        leaves = leaves[bvh.count[leaves] > 0]
        if len(leaves) == 0:
            continue
        starts = bvh.start[leaves]
        counts = bvh.count[leaves]
        lo_p = int(starts.min())
        hi_p = int((starts + counts).max())
        cnt = hi_p - lo_p
        assert cnt <= k, (cnt, k)
        tri_index[j, :cnt] = np.arange(lo_p, hi_p, dtype=np.int32)
        tv0[j, :cnt] = v0r[lo_p:hi_p]
        te1[j, :cnt] = e1[lo_p:hi_p]
        te2[j, :cnt] = e2[lo_p:hi_p]

    return Treelets(bmin=bmin, bmax=bmax, tri_index=tri_index,
                    v0=tv0, e1=te1, e2=te2)


def treelet_block(tl: Treelets) -> np.ndarray:
    """Host Treelets -> the (NT, 9, K) f32 triangle block."""
    return np.stack(
        [tl.v0[..., 0], tl.v0[..., 1], tl.v0[..., 2],
         tl.e1[..., 0], tl.e1[..., 1], tl.e1[..., 2],
         tl.e2[..., 0], tl.e2[..., 1], tl.e2[..., 2]],
        axis=1,
    ).astype(np.float32)


def make_treelet_geom(tl: Treelets, device) -> TreeletGeom:
    """Convert host Treelets to the packed device table."""
    return TreeletGeom(
        bmin=torch.as_tensor(np.asarray(tl.bmin, np.float32), device=device),
        bmax=torch.as_tensor(np.asarray(tl.bmax, np.float32), device=device),
        tri_index=torch.as_tensor(np.asarray(tl.tri_index, np.int32),
                                  device=device),
        block=torch.as_tensor(treelet_block(tl), device=device),
    )
