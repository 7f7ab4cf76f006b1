"""Device geometry tables: the treelet table the trace kernels read and
the flat BVH triangle arrays the shading code gathers from.

The host-side treelet cut is the reference package's numpy
`bpt_tpu.accel.treelets.build_treelets` (a treelet is a BVH subtree whose
triangles span a contiguous BVH-order range of at most K); this module
turns its output into tensors.  `TreeletGeom` / `make_treelet_geom` port
bpt_tpu/accel/binned.py:35-62 (the rest of binned.py is an XLA tracer for
the TPU and has no counterpart here).  `TraceGeom` mirrors
bpt_tpu/accel/traverse.py's record so that a scene has the same fields in
both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


def treelet_block(tl) -> np.ndarray:
    """Host Treelets (bpt_tpu/accel/treelets.py) -> the (NT, 9, K) f32
    triangle block."""
    return np.stack(
        [tl.v0[..., 0], tl.v0[..., 1], tl.v0[..., 2],
         tl.e1[..., 0], tl.e1[..., 1], tl.e1[..., 2],
         tl.e2[..., 0], tl.e2[..., 1], tl.e2[..., 2]],
        axis=1,
    ).astype(np.float32)


def make_treelet_geom(tl, device) -> TreeletGeom:
    """Convert host Treelets to the packed device table."""
    return TreeletGeom(
        bmin=torch.as_tensor(np.asarray(tl.bmin, np.float32), device=device),
        bmax=torch.as_tensor(np.asarray(tl.bmax, np.float32), device=device),
        tri_index=torch.as_tensor(np.asarray(tl.tri_index, np.int32),
                                  device=device),
        block=torch.as_tensor(treelet_block(tl), device=device),
    )
