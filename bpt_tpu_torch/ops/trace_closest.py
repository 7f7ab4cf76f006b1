"""K1, K3, K5 and K6: closest hit over the treelet table.

K1 (`closest_hit`, kernel bpt_tpu_torch/csrc/closest_hit.cu) replaces the
TPU kernel bpt_tpu/ops/pallas_trace.py::trace_closest_compact and takes
tables of at most MAX_TREELETS treelets.  K3 (`closest_hit_stream`,
kernel bpt_tpu_torch/csrc/closest_hit_stream.cu) replaces
bpt_tpu/ops/pallas_sweep.py::trace_closest_stream: K1's closest hit, bit
for bit, on tables of any size, with the table taken in groups of
`chunk_nt` consecutive treelets behind their union boxes
(accel/treelets.py::group_boxes).  K5 (`closest_hit_full`,
csrc/closest_hit_full.cu) replaces pallas_trace.py::trace_closest_pallas:
K1's function on K1's table (its packed rows), with each ray's treelet
entries computed once by its warp into a list that the ray walks in
order.  K6 (`closest_hit_sweep`, csrc/closest_hit_sweep.cu) replaces
pallas_sweep.py::trace_closest_sweep: one visit order shared by a tile of
SWEEP_TILE lanes, sorted in shared memory.

Each wrapper runs its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors, or raises.  `<wrapper>.launches`
counts kernel launches; `<plain>.cuda_calls` counts calls of a plain
version with CUDA tensors (a comparison harness, never a route).

One tie rule for K1, K3 and K5: a lane visits the treelets it overlaps
in (entry, index) order over the whole table while entry < t_best,
strict `<` to improve, lowest slot k on an equal t.  K6 differs only in
the order: a tile visits treelets by (tile-minimum entry, index), so
where two triangles of different treelets give exactly the same t, K6
keeps the one its tile reached first.  The reference's streamed kernel
shares K6's tile order (pallas_sweep.py::_closest_body), so K3 and the
reference's trace_closest_stream differ only on such ties.  A miss or
dead lane gives (inf, -1, 0, 0).
"""
from __future__ import annotations

import torch

from . import _build
from ..accel.treelets import (group_boxes, packed_triangles, triangle_counts,
                              triangle_rows)
from .intersect import SLAB_ELEMS, check_trace_args, moller_trumbore, slab

# Lanes per tile of K6: one CUDA block (csrc/intersect.cuh kThreads) and
# the reference's tile (pallas_sweep.py TILE).  Part of K6's function.
SWEEP_TILE = 128
# Lanes per triangle-test step of the plain versions (bounds their (n, K)
# temporaries).
_PLAIN_CHUNK = 1 << 16


def _closest_walk(tg, o, d, min_t, max_t):
    """The plain closest hit: each live lane visits the treelets it
    overlaps in (entry, index) order while entry < t_best.  Temporaries
    are at most (SLAB_ELEMS / NT lanes, NT)."""
    nt = tg.block.shape[0]
    best = _miss(o.shape[0], o.device)
    live = torch.nonzero(max_t >= min_t).squeeze(1)
    lanes = max(1, SLAB_ELEMS // max(nt, 1))
    for s0 in range(0, live.numel(), lanes):
        ln = live[s0:s0 + lanes]
        _, entry = slab(tg.bmin, tg.bmax, o[ln], d[ln], min_t[ln], max_t[ln])
        entry_s, order = torch.sort(entry, dim=1, stable=True)
        del entry
        for r in range(nt):
            # Entries are sorted and t_best only shrinks, so once no lane
            # is active at rank r none is at a later rank.
            act = torch.nonzero(entry_s[:, r] < best[0][ln]).squeeze(1)
            if act.numel() == 0:
                break
            _visit(tg, o, d, min_t, max_t, ln[act], order[act, r], best)
    return best


def _miss(b, device):
    return (torch.full((b,), torch.inf, dtype=torch.float32, device=device),
            torch.full((b,), -1, dtype=torch.int32, device=device),
            torch.zeros((b,), dtype=torch.float32, device=device),
            torch.zeros((b,), dtype=torch.float32, device=device))


def _visit(tg, o, d, min_t, max_t, lanes, rows, best):
    """Test lanes `lanes` against treelets `rows` ((n,) each) and improve
    `best` = (t, tri, u, v) in place: the lowest t of the treelet wins,
    the lowest slot an equal t, and it replaces the best hit only if
    strictly nearer."""
    t_best, tri_best, u_best, v_best = best
    k = tg.block.shape[2]
    slots = torch.arange(k, device=o.device)
    for s in range(0, lanes.numel(), _PLAIN_CHUNK):
        a = lanes[s:s + _PLAIN_CHUNK]
        j = rows[s:s + _PLAIN_CHUNK]
        ok, tt, uu, vv = moller_trumbore(tg.block[j], o[a], d[a])
        tb = t_best[a]
        t_hi = torch.minimum(tb, max_t[a])
        ok &= (tt >= min_t[a, None]) & (tt <= t_hi[:, None])
        t_m = torch.where(ok, tt, torch.full_like(tt, torch.inf))
        t_new = torch.amin(t_m, dim=1)
        kk = torch.where(t_m == t_new[:, None], slots, k).amin(dim=1)
        improved = t_new < tb
        a, j, kk = a[improved], j[improved], kk[improved]
        i = torch.nonzero(improved).squeeze(1)
        t_best[a] = t_new[improved]
        tri_best[a] = tg.tri_index[j, kk]
        u_best[a] = uu[i, kk]
        v_best[a] = vv[i, kk]


def closest_hit_plain(tg, o, d, min_t, max_t):
    """Plain PyTorch version of K1."""
    if o.is_cuda:
        closest_hit_plain.cuda_calls += 1
    return _closest_walk(tg, o, d, min_t, max_t)


closest_hit_plain.cuda_calls = 0


def closest_hit_stream_plain(tg, o, d, min_t, max_t, chunk_nt):
    """Plain PyTorch version of K3: K1's function, which the group size
    `chunk_nt` does not change."""
    if o.is_cuda:
        closest_hit_stream_plain.cuda_calls += 1
    return _closest_walk(tg, o, d, min_t, max_t)


closest_hit_stream_plain.cuda_calls = 0


def closest_hit_full_plain(tg, o, d, min_t, max_t):
    """Plain PyTorch version of K5: K1's function."""
    if o.is_cuda:
        closest_hit_full_plain.cuda_calls += 1
    return _closest_walk(tg, o, d, min_t, max_t)


closest_hit_full_plain.cuda_calls = 0


def closest_hit_sweep_plain(tg, o, d, min_t, max_t):
    """Plain PyTorch version of K6, vectorised over tiles of SWEEP_TILE
    consecutive lanes (the last one padded with lanes that overlap
    nothing).

    A tile visits the treelets any of its lanes overlaps (dead lanes
    included, as in the reference) in (tile-minimum entry, index) order;
    a live lane tests a visited treelet when its own entry is below its
    t_best.  Removing a visited treelet leaves the other tile minima as
    they are, so the order is one sort per tile.  Tiles go in groups of
    at most SLAB_ELEMS (lane, treelet) entries."""
    if o.is_cuda:
        closest_hit_sweep_plain.cuda_calls += 1
    b = o.shape[0]
    nt = tg.block.shape[0]
    dev = o.device
    best = _miss(b, dev)
    if b == 0 or nt == 0:
        return best
    live = max_t >= min_t
    group = max(1, SLAB_ELEMS // (SWEEP_TILE * nt)) * SWEEP_TILE
    for g0 in range(0, b, group):
        g1 = min(g0 + group, b)
        n_tiles = -(-(g1 - g0) // SWEEP_TILE)
        pad = n_tiles * SWEEP_TILE - (g1 - g0)
        _, entry = slab(tg.bmin, tg.bmax, o[g0:g1], d[g0:g1], min_t[g0:g1],
                        max_t[g0:g1])
        # +0.0 turns a -0.0 entry into +0.0, as the kernel does before its
        # integer atomicMin.
        entry = torch.cat([entry + 0.0, torch.full((pad, nt), torch.inf,
                                                   device=dev)])
        entry = entry.view(n_tiles, SWEEP_TILE, nt)
        key, order = torch.sort(entry.amin(dim=1), dim=1, stable=True)
        steps = int(torch.isfinite(key).sum(dim=1).max())
        lane = g0 + torch.arange(n_tiles * SWEEP_TILE, device=dev)
        ok_lane = torch.cat([live[g0:g1],
                             torch.zeros((pad,), dtype=torch.bool,
                                         device=dev)])
        for r in range(steps):
            j = order[:, r]
            e = entry.gather(2, j[:, None, None].expand(-1, SWEEP_TILE, 1))
            t_best = torch.cat([best[0][g0:g1],
                                torch.full((pad,), torch.inf, device=dev)])
            # Later entries of a lane are no nearer than this tile minimum.
            if not bool((ok_lane & (t_best > key[:, r].repeat_interleave(
                    SWEEP_TILE))).any()):
                break
            act = torch.nonzero(ok_lane & (e.view(-1) < t_best)).squeeze(1)
            if act.numel():
                _visit(tg, o, d, min_t, max_t, lane[act],
                       j[act // SWEEP_TILE], best)
    return best


closest_hit_sweep_plain.cuda_calls = 0


def _outputs(b, device):
    return (torch.empty((b,), dtype=torch.float32, device=device),
            torch.empty((b,), dtype=torch.int32, device=device),
            torch.empty((b,), dtype=torch.float32, device=device),
            torch.empty((b,), dtype=torch.float32, device=device))


def _launch_packed(name, tg, o, d, min_t, max_t, b, nt, counter=None):
    """Launch a closest-hit kernel that reads the table's boxes and its
    packed triangles (accel/treelets.py::packed_triangles): K1, K5, K6.
    `counter`: the kernel's zeroed int32 counters (one word by default;
    K5 takes two)."""
    out = _outputs(b, o.device)
    rows, offsets = packed_triangles(tg)
    if counter is None:
        counter = torch.zeros((1,), dtype=torch.int32, device=o.device)
    _build.launch(name, o.device, tg.bmin.data_ptr(), tg.bmax.data_ptr(),
                  rows.data_ptr(), offsets.data_ptr(), nt, rows.shape[0],
                  o.data_ptr(), d.data_ptr(), min_t.data_ptr(),
                  max_t.data_ptr(), b, *(x.data_ptr() for x in out),
                  counter.data_ptr())
    return out


def closest_hit(tg, o, d, min_t, max_t):
    """K1: closest hit of rays (B, 3) with (B,) windows against a table of
    at most MAX_TREELETS treelets.  Returns (t, tri, u, v), each (B,)."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t)
    if o.device.type == "cpu":
        return closest_hit_plain(tg, o, d, min_t, max_t)
    if b == 0:
        return _outputs(0, o.device)
    out = _launch_packed("bpt_closest_hit", tg, o, d, min_t, max_t, b, nt)
    closest_hit.launches += 1
    return out


closest_hit.launches = 0


def closest_hit_stream(tg, o, d, min_t, max_t, chunk_nt):
    """K3: K1's closest hit of rays (B, 3) with (B,) windows against a
    table of any size, taken in groups of `chunk_nt` (1..MAX_TREELETS)
    treelets.  Returns (t, tri, u, v), each (B,).  Raises if the card
    cannot hold the group boxes in one block's shared memory."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t, chunk_nt)
    if o.device.type == "cpu":
        return closest_hit_stream_plain(tg, o, d, min_t, max_t, chunk_nt)
    out = _outputs(b, o.device)
    if b == 0:
        return out
    gmin, gmax = group_boxes(tg, chunk_nt)
    counter = torch.zeros((1,), dtype=torch.int32, device=o.device)
    _build.launch("bpt_closest_hit_stream", o.device, tg.bmin.data_ptr(),
                  tg.bmax.data_ptr(), gmin.data_ptr(), gmax.data_ptr(),
                  triangle_rows(tg).data_ptr(),
                  triangle_counts(tg).data_ptr(), tg.tri_index.data_ptr(), nt,
                  gmin.shape[0], chunk_nt, k, o.data_ptr(), d.data_ptr(),
                  min_t.data_ptr(), max_t.data_ptr(), b,
                  *(x.data_ptr() for x in out), counter.data_ptr())
    closest_hit_stream.launches += 1
    return out


closest_hit_stream.launches = 0


def closest_hit_full(tg, o, d, min_t, max_t):
    """K5, the counterpart of the TPU kernel trace_closest_pallas: K1's
    closest hit, bit for bit, with each ray's treelet entries computed
    once by its warp into a list that it walks in order.  At most
    MAX_TREELETS treelets.  Returns (t, tri, u, v), each (B,).

    After a launch, `closest_hit_full.overflow_lanes` is a (1,) int32
    tensor on the card: the lanes of that launch whose list overflowed
    and which took K1's walk instead (read it after a synchronize)."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t)
    if o.device.type == "cpu":
        return closest_hit_full_plain(tg, o, d, min_t, max_t)
    if b == 0:
        return _outputs(0, o.device)
    counter = torch.zeros((2,), dtype=torch.int32, device=o.device)
    out = _launch_packed("bpt_closest_hit_full", tg, o, d, min_t, max_t, b,
                         nt, counter)
    closest_hit_full.launches += 1
    closest_hit_full.overflow_lanes = counter[1:]
    return out


closest_hit_full.launches = 0
closest_hit_full.overflow_lanes = None


def closest_hit_sweep(tg, o, d, min_t, max_t):
    """K6, the counterpart of the TPU kernel trace_closest_sweep: closest
    hit with one treelet order per tile of SWEEP_TILE consecutive lanes.
    At most MAX_TREELETS treelets.  Returns (t, tri, u, v), each (B,)."""
    b, nt, k = check_trace_args(tg, o, d, min_t, max_t)
    if o.device.type == "cpu":
        return closest_hit_sweep_plain(tg, o, d, min_t, max_t)
    if b == 0:
        return _outputs(0, o.device)
    out = _launch_packed("bpt_closest_hit_sweep", tg, o, d, min_t, max_t, b,
                         nt)
    closest_hit_sweep.launches += 1
    return out


closest_hit_sweep.launches = 0
