"""Scene-level tracing (port of bpt_tpu/accel/api.py).

A scene without a treelet table (`scene.treelets` is None) is traced by
the stackless BVH walk of accel/traverse.py, without compaction, as the
reference routes it.  Otherwise both traces run behind live-lane
compaction with spatial cluster keys (ops/compaction.py), then go by the
treelet count of their table:

  * NT <= MAX_TREELETS (2048): closest hit through K1
    (ops/trace_closest.py::closest_hit), any hit through K2
    (ops/trace_any.py::any_hit);
  * NT > MAX_TREELETS: the streamed kernels, closest hit through K3
    (closest_hit_stream), any hit through K4 (any_hit_stream), in groups
    of STREAM_CHUNK treelets.

The threshold is the port's own: K1 and K2 keep every box of the table
in 48 KB of shared memory, so the limit is shared memory, not VMEM.  The
reference streams once its tables exceed the TPU's 8 MiB VMEM budget,
from about 1,640 treelets for closest hit and about 820 for any hit, so a
923-treelet scene already streams any-hit on the TPU; in the port it
does not.  The same rule holds on the CPU, where the wrappers run their
plain versions; the tensors' device picks kernel or plain version and
nothing else.
"""
from __future__ import annotations

import torch

from . import traverse
from ..ops.compaction import compact_rays, uncompact, uncompact_many
from ..ops.intersect import MAX_TREELETS, STREAM_CHUNK
from ..ops.trace_any import any_hit, any_hit_stream
from ..ops.trace_closest import closest_hit, closest_hit_stream
from .traverse import Hit


def scene_bounds(tg):
    """The scene box (bmin, bmax) of a treelet table."""
    return torch.amin(tg.bmin, dim=0), torch.amax(tg.bmax, dim=0)


def trace_closest(scene, o, d, min_t, max_t) -> Hit:
    """Closest hit of (B,) rays; min_t / max_t are (B,) tensors or floats."""
    tg = getattr(scene, "treelets", None)
    if tg is None:
        return traverse.trace_closest(scene.geom, o, d, min_t, max_t)
    o_c, d_c, mn_c, mx_c, plan = compact_rays(
        o, d, min_t, max_t, bounds=scene_bounds(tg), kind="ray")
    args = (tg, o_c.contiguous(), d_c.contiguous(), mn_c, mx_c)
    if tg.block.shape[0] <= MAX_TREELETS:
        h = closest_hit(*args)
    else:
        h = closest_hit_stream(*args, STREAM_CHUNK)
    t, tri, u, v = uncompact_many(h, plan, (torch.inf, -1, 0.0, 0.0))
    return Hit(t=t, tri=tri, u=u, v=v, valid=tri >= 0)


def trace_any(scene, o, d, min_t, max_t):
    """(B,) occlusion flags of segments; dead lanes are unoccluded."""
    if getattr(scene, "treelets", None) is None:
        return traverse.trace_any(scene.geom, o, d, min_t, max_t)
    tg = scene.treelets_any
    o_c, d_c, mn_c, mx_c, plan = compact_rays(
        o, d, min_t, max_t, bounds=scene_bounds(tg))
    args = (tg, o_c.contiguous(), d_c.contiguous(), mn_c, mx_c)
    if tg.block.shape[0] <= MAX_TREELETS:
        occ = any_hit(*args)
    else:
        occ = any_hit_stream(*args, STREAM_CHUNK)
    return uncompact(occ, plan, False)
