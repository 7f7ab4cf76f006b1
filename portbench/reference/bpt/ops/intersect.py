"""Intersection arithmetic of the plain walks (a frozen copy of
bpt_tpu_torch/ops/intersect.py without its wrappers' argument checks).
The operation order is that of the port's CUDA kernels, so that the
reference and the kernels round alike.
"""
from __future__ import annotations

import torch

from ..core.math import EPSILON, T_MIN_HIT

# Elements of a plain version's (lanes, treelets) slab matrix per step.
SLAB_ELEMS = 1 << 26


def safe_inv(c):
    """1/c with the reference's +-1e-20 floor on |c| (traverse.py
    `_safe_inv`), so slab tests stay NaN-free."""
    sign = torch.where(c < 0, -1.0, 1.0).to(c.dtype)
    return sign / torch.clamp_min(torch.abs(c), 1e-20)


def slab(bmin, bmax, o, d, min_t, max_t):
    """(B, NT) ray x box overlap mask and entry distances
    max(tnear, 0) (+inf where the ray misses the box)."""
    b, nt = o.shape[0], bmin.shape[0]
    tnear = torch.full((b, nt), -torch.inf, dtype=o.dtype, device=o.device)
    tfar = torch.full((b, nt), torch.inf, dtype=o.dtype, device=o.device)
    for axis in range(3):
        ic = safe_inv(d[:, axis])[:, None]
        oc = o[:, axis, None]
        t1 = (bmin[None, :, axis] - oc) * ic
        t2 = (bmax[None, :, axis] - oc) * ic
        tnear = torch.maximum(tnear, torch.minimum(t1, t2))
        tfar = torch.minimum(tfar, torch.maximum(t1, t2))
    mask = (tfar >= tnear) & (tnear <= max_t[:, None]) & (tfar >= min_t[:, None])
    entry = torch.where(mask, torch.clamp_min(tnear, 0.0),
                        torch.full_like(tnear, torch.inf))
    return mask, entry


def moller_trumbore(blk, o, d):
    """Moeller-Trumbore of rays against triangle blocks.

    blk: (n, 9, K) or (1, 9, K) rows (v0xyz, e1xyz, e2xyz); o, d: (n, 3).
    Returns (ok, t, u, v), each (n, K); ok already holds |det| >= EPSILON,
    u, v in the triangle and t > T_MIN_HIT."""
    v0x, v0y, v0z = blk[:, 0], blk[:, 1], blk[:, 2]
    e1x, e1y, e1z = blk[:, 3], blk[:, 4], blk[:, 5]
    e2x, e2y, e2z = blk[:, 6], blk[:, 7], blk[:, 8]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) >= EPSILON
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv_det
    ok &= (uu >= 0.0) & (uu <= 1.0)
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    ok &= (vv >= 0.0) & (uu + vv <= 1.0)
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok &= tt > T_MIN_HIT
    return ok, tt, uu, vv
