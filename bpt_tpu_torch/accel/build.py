"""Host-side BVH builder: flat, threaded (skip-link) nodes over triangles
(port of the midpoint builder of bpt_tpu/accel/build.py).

A binary BVH with midpoint splits on the longest centroid-extent axis and
leaf size LEAF_SIZE, as the reference renderer's Fast-BVH builds it,
stored as a threaded array:

  * nodes are in DFS preorder; an inner node's "hit" successor is `i + 1`
    (its first child);
  * every node stores a `miss` link, the next node in preorder after its
    whole subtree, taken on a box miss and after a leaf;
  * leaf primitives are reordered to be contiguous.

`build_bvh` builds with the native C++ builder (`native/native.py`, a
copy of the reference's, compiled at first use); `build_bvh_numpy`, a
copy of the reference's numpy construction, is its plain version, which
the tests hold it to: both give exactly the reference's
`build_bvh(..., use_native=False)` tree.  The reference's binned-SAH
option is not ported.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from ..native.native import build_bvh_native

LEAF_SIZE = 4  # matches Fast-BVH


@dataclasses.dataclass
class FlatBVH:
    """Flat threaded BVH. All numpy host arrays."""

    bmin: np.ndarray        # (N, 3) f32
    bmax: np.ndarray        # (N, 3) f32
    miss: np.ndarray        # (N,) i32 skip link (== N past the last subtree)
    start: np.ndarray       # (N,) i32 leaf primitive start (0 for inner)
    count: np.ndarray       # (N,) i32 leaf primitive count (0 for inner)
    prim_order: np.ndarray  # (T,) i32: new_index -> original triangle index

    @property
    def n_nodes(self) -> int:
        return self.bmin.shape[0]


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> FlatBVH:
    """Midpoint BVH over triangles given by (T, 3) vertex arrays, built by
    the native builder (raises where no C++ compiler can build it)."""
    return FlatBVH(*build_bvh_native(v0, v1, v2))


def build_bvh_numpy(v0: np.ndarray, v1: np.ndarray,
                    v2: np.ndarray) -> FlatBVH:
    """The same tree in numpy: preorder recursive construction, per-node
    work vectorised over the node's primitive slice."""
    t = v0.shape[0]
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)
    centroid = (v0.astype(np.float64) + v1 + v2) / 3.0

    order = np.arange(t, dtype=np.int64)
    bmin_l: list = []
    bmax_l: list = []
    miss_l: list = []
    start_l: list = []
    count_l: list = []

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * t))

    def rec(lo_r: int, hi_r: int) -> None:
        node = len(bmin_l)
        sl = order[lo_r:hi_r]
        bmin_l.append(lo[sl].min(axis=0))
        bmax_l.append(hi[sl].max(axis=0))
        miss_l.append(0)
        start_l.append(0)
        count_l.append(0)
        n = hi_r - lo_r
        leaf = n <= LEAF_SIZE
        if not leaf:
            c = centroid[sl]
            cmin = c.min(axis=0)
            cmax = c.max(axis=0)
            axis = int(np.argmax(cmax - cmin))
            split = 0.5 * (cmin[axis] + cmax[axis])
            left_mask = c[:, axis] < split
            n_left = int(left_mask.sum())
            if n_left == 0 or n_left == n:
                # Degenerate centroid split: a leaf.
                leaf = True
            else:
                order[lo_r:hi_r] = np.concatenate(
                    [sl[left_mask], sl[~left_mask]]
                )
                rec(lo_r, lo_r + n_left)
                rec(lo_r + n_left, hi_r)
        if leaf:
            start_l[node] = lo_r
            count_l[node] = n
        miss_l[node] = len(bmin_l)  # next preorder node after this subtree

    try:
        if t > 0:
            rec(0, t)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        bmin=np.asarray(bmin_l, np.float32).reshape(-1, 3),
        bmax=np.asarray(bmax_l, np.float32).reshape(-1, 3),
        miss=np.asarray(miss_l, np.int32),
        start=np.asarray(start_l, np.int32),
        count=np.asarray(count_l, np.int32),
        prim_order=order.astype(np.int32),
    )
