"""Treelet tables: the host-side treelet cut, the device table the trace
kernels read, the two tables the streamed kernels derive from it, and
the flat BVH triangle arrays the shading code gathers from.

`build_treelets` is a copy of the reference package's numpy cut
(bpt_tpu/accel/treelets.py): a treelet is a BVH subtree whose triangles
span a contiguous BVH-order range of at most K.  `TreeletGeom` /
`make_treelet_geom` port bpt_tpu/accel/binned.py:35-62 (the rest of
binned.py is an XLA tracer for the TPU and has no counterpart here).
`TraceGeom` mirrors bpt_tpu/accel/traverse.py's record so that a scene
has the same fields in both packages.  `group_boxes`, `triangle_rows`,
`triangle_counts` and `packed_triangles` are the port's own: the union
box of each run of G consecutive treelets, which the streamed kernels K3
and K4 test before the members' boxes; the triangles laid out one slot
per 48 bytes for those kernels' loads, with each treelet's count of
slots up to its last triangle; and, for K1, K2, K6 and K7, the same
rows packed to their counts behind an offset table.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

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


# The tables K3 and K4 derive from a treelet table, built at the first
# call that needs them and kept while the tensor they derive from lives:
# that tensor (compared by identity) -> {name: derived table}.
_DERIVED = WeakIdKeyDictionary()


def _derived(source: torch.Tensor, name, build):
    per_source = _DERIVED.setdefault(source, {})
    if name not in per_source:
        per_source[name] = build()
    return per_source[name]


def triangle_rows(tg: TreeletGeom) -> torch.Tensor:
    """The triangles of `tg` as (NT, K, 12) f32 rows, one per slot:
    (v0 xyz, e1 xyz, e2 xyz, 0, 0, 0).  A slot's 48 bytes are contiguous
    and 16-byte aligned, so a kernel thread reads a triangle with three
    16-byte loads, where the (NT, 9, K) block takes nine 4-byte loads
    from nine rows.  The same floats as the block; built once per
    block."""
    def build():
        nt, _, k = tg.block.shape
        rows = tg.block.new_zeros((nt, k, 12))
        rows[..., :9] = tg.block.transpose(1, 2)
        return rows

    return _derived(tg.block, "rows", build)


def triangle_counts(tg: TreeletGeom) -> torch.Tensor:
    """(NT,) i32: the slots of each treelet up to its last slot that is
    not all zero.  The slots after it are the cut's pads, all zero, which
    no ray hits (det = 0), so a kernel may stop there.  Built once per
    block."""
    def build():
        filled = (tg.block != 0).any(dim=1)  # (NT, K)
        slot = torch.arange(1, filled.shape[1] + 1, dtype=torch.int32,
                            device=filled.device)
        return torch.where(filled, slot, 0).amax(dim=1)

    return _derived(tg.block, "counts", build)


def packed_triangles(tg: TreeletGeom):
    """The triangles of `tg` packed to their counts, for K1, K2, K6 and
    K7: (rows, offsets).  `rows` is (S, 12) i32, S = sum(triangle_counts):
    treelet j's slots [0, count_j) in slot order as rows [offsets[j],
    offsets[j + 1]), each the bits of (v0 xyz, e1 xyz, e2 xyz) followed
    by the slot's `tri_index` and two zeros, 48 bytes, 16-byte aligned.
    `offsets` is (NT + 1,) i32.  The pad slots past a treelet's last
    triangle are left out (no ray hits them), so the bench table's rows
    fit in a block's shared memory.  Built once per block."""
    def build():
        nt, _, k = tg.block.shape
        counts = triangle_counts(tg)
        offsets = torch.zeros((nt + 1,), dtype=torch.int32,
                              device=counts.device)
        offsets[1:] = torch.cumsum(counts, dim=0)
        keep = (torch.arange(k, device=counts.device)[None, :]
                < counts[:, None])  # (NT, K), row-major = slot order
        rows = torch.zeros((int(offsets[-1]), 12), dtype=torch.int32,
                           device=counts.device)
        rows[:, :9] = tg.block.transpose(1, 2)[keep].view(torch.int32)
        rows[:, 9] = tg.tri_index[keep]
        return rows, offsets

    return _derived(tg.block, "packed", build)


def group_boxes(tg: TreeletGeom, g: int):
    """The union box of each run of `g` consecutive treelets of `tg`:
    (gmin, gmax), each (ceil(NT / g), 3) f32 on the table's device, the
    last group ragged.  Treelets are in BVH order, so a group is a few
    neighbouring subtrees and its box is tight.  Built once per box
    table and group size (amin / amax over a reshape); a table's bmin and
    bmax are made together (make_treelet_geom), so bmin stands for
    both."""
    def build():
        nt = tg.bmin.shape[0]
        ng = -(-nt // g)
        pad = ng * g - nt

        def union(x, fill, reduce):
            x = torch.cat([x, x.new_full((pad, 3), fill)])
            return reduce(x.view(ng, g, 3), dim=1).contiguous()

        return (union(tg.bmin, torch.inf, torch.amin),
                union(tg.bmax, -torch.inf, torch.amax))

    return _derived(tg.bmin, ("groups", g), build)
