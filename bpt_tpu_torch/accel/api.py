"""Scene-level tracing (port of bpt_tpu/accel/api.py).

Both traces run behind live-lane compaction with spatial cluster keys
(ops/compaction.py): closest hit through K1 (ops/trace_closest.py), any
hit through K2 (ops/trace_any.py).  The route is the tensors' device and
nothing else: CUDA tensors launch the kernels, CPU tensors run their
plain versions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.compaction import compact_rays, uncompact, uncompact_many
from ..ops.trace_any import any_hit
from ..ops.trace_closest import closest_hit


class Hit(NamedTuple):
    """Closest-hit record, (B,) each.  `tri` indexes the BVH-ordered
    triangle arrays; -1 / valid=False on a miss."""

    t: torch.Tensor
    tri: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor


def scene_bounds(tg):
    """The scene box (bmin, bmax) of a treelet table."""
    return torch.amin(tg.bmin, dim=0), torch.amax(tg.bmax, dim=0)


def trace_closest(scene, o, d, min_t, max_t) -> Hit:
    """Closest hit of (B,) rays; min_t / max_t are (B,) tensors or floats."""
    tg = scene.treelets
    o_c, d_c, mn_c, mx_c, plan = compact_rays(
        o, d, min_t, max_t, bounds=scene_bounds(tg), kind="ray")
    h = closest_hit(tg, o_c.contiguous(), d_c.contiguous(), mn_c, mx_c)
    t, tri, u, v = uncompact_many(h, plan, (torch.inf, -1, 0.0, 0.0))
    return Hit(t=t, tri=tri, u=u, v=v, valid=tri >= 0)


def trace_any(scene, o, d, min_t, max_t):
    """(B,) occlusion flags of segments; dead lanes are unoccluded."""
    tg = scene.treelets_any
    o_c, d_c, mn_c, mx_c, plan = compact_rays(
        o, d, min_t, max_t, bounds=scene_bounds(tg))
    occ = any_hit(tg, o_c.contiguous(), d_c.contiguous(), mn_c, mx_c)
    return uncompact(occ, plan, False)
