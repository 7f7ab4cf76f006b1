"""Stackless threaded-BVH traversal (port of bpt_tpu/accel/traverse.py).

Each ray walks the threaded BVH of `TraceGeom` (bpt_tpu/accel/build.py:
descend to node + 1 on a box hit, else jump to the node's miss link)
until its cursor leaves the node array.  Leaves hold at most LEAF_SIZE
triangles, tested with Moeller-Trumbore (|det| >= EPSILON, t >
T_MIN_HIT, t in [min_t, min(t_best, max_t)]); the lowest t wins and the
lowest leaf slot wins an equal t.  `trace_any` stops a lane at its first
occluding leaf.

The reference runs every lane in lockstep inside one while loop; here
each iteration works on the lanes whose cursor is still inside the tree,
which gives the same results.  It is plain PyTorch with no kernel (the
reference has no Pallas kernel here) and runs on either device: it is
the independent reference the seven treelet tracers are tested against,
and `accel/api.py` routes a scene without a treelet table to it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.intersect import moller_trumbore, safe_inv

LEAF_SIZE = 4


class Hit(NamedTuple):
    """Closest-hit record, (B,) each.  `tri` indexes the BVH-ordered
    triangle arrays; -1 / valid=False on a miss."""

    t: torch.Tensor
    tri: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor


def _window(x, b, device):
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device).expand(b).contiguous()


def _slab_hit(bmin, bmax, o, inv_d, t_lo, t_hi):
    """Slab test of (n, 3) boxes against the interval [t_lo, t_hi]."""
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tnear = torch.amax(torch.minimum(t1, t2), dim=-1)
    tfar = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (tfar >= tnear) & (tnear <= t_hi) & (tfar >= t_lo)


def _leaf_test(geom, o, d, start, count):
    """Moeller-Trumbore of (n,) rays against their leaves' slots:
    (triangle index, ok, t, u, v), each (n, LEAF_SIZE)."""
    slots = torch.arange(LEAF_SIZE, device=o.device)
    idx = start[:, None].long() + slots
    blk = torch.cat([geom.v0[idx], geom.e1[idx], geom.e2[idx]],
                    dim=-1).transpose(1, 2)                 # (n, 9, LEAF)
    ok, t, u, v = moller_trumbore(blk, o, d)
    return idx, ok & (slots < count[:, None]), t, u, v


def _walk(geom, o, d, min_t, max_t, occlusion):
    b = o.shape[0]
    dev = o.device
    n_nodes = geom.node_bmin.shape[0]
    inv_d = safe_inv(d)
    min_t, max_t = _window(min_t, b, dev), _window(max_t, b, dev)
    cur = torch.zeros((b,), dtype=torch.long, device=dev)
    t_best = torch.full((b,), torch.inf, dtype=torch.float32, device=dev)
    tri_best = torch.full((b,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((b,), dtype=torch.float32, device=dev)
    v_best = torch.zeros((b,), dtype=torch.float32, device=dev)
    occ = torch.zeros((b,), dtype=torch.bool, device=dev)
    act = torch.arange(b, device=dev) if n_nodes else cur[:0]
    while act.numel():
        c = cur[act]
        count = geom.node_count[c]
        t_hi = max_t[act] if occlusion else torch.minimum(t_best[act],
                                                          max_t[act])
        box_hit = _slab_hit(geom.node_bmin[c], geom.node_bmax[c], o[act],
                            inv_d[act], min_t[act], t_hi)
        leaf = torch.nonzero(box_hit & (count > 0)).squeeze(1)
        if leaf.numel():
            a = act[leaf]
            idx, ok, t, u, v = _leaf_test(geom, o[a], d[a],
                                          geom.node_start[c[leaf]],
                                          count[leaf])
            ok &= (t >= min_t[a, None]) & (t <= t_hi[leaf, None])
            if occlusion:
                occ[a] |= ok.any(dim=1)
            else:
                t_m = torch.where(ok, t, torch.full_like(t, torch.inf))
                k = torch.argmin(t_m, dim=1, keepdim=True)
                t_new = t_m.gather(1, k)[:, 0]
                imp = t_new < t_best[a]
                a, k = a[imp], k[imp]
                t_best[a] = t_new[imp]
                tri_best[a] = idx[imp].gather(1, k)[:, 0].to(torch.int32)
                u_best[a] = u[imp].gather(1, k)[:, 0]
                v_best[a] = v[imp].gather(1, k)[:, 0]
        nxt = torch.where(box_hit & (count <= 0), c + 1,
                          geom.node_miss[c].long())
        if occlusion:
            nxt = torch.where(occ[act], n_nodes, nxt)
        cur[act] = nxt
        act = act[nxt < n_nodes]
    if occlusion:
        return occ
    return Hit(t=t_best, tri=tri_best, u=u_best, v=v_best, valid=tri_best >= 0)


def trace_closest(geom, o, d, min_t, max_t) -> Hit:
    """Closest hit of (B, 3) rays; min_t / max_t are (B,) tensors or
    floats."""
    return _walk(geom, o, d, min_t, max_t, occlusion=False)


def trace_any(geom, o, d, min_t, max_t) -> torch.Tensor:
    """(B,) occlusion flags: a hit with t in [min_t, max_t] exists."""
    return _walk(geom, o, d, min_t, max_t, occlusion=True)
