"""Scene-level tracing of the reference: every trace in plain PyTorch.

The program routes a scene with a treelet table through live-lane
compaction to its trace kernels; the reference traces every lane of the
batch with the plain walks of ops/trace_closest.py and ops/trace_any.py,
whose function is the kernels' (dead lanes miss either way, and each
lane's result depends on its own ray alone).  A scene without a table
takes the BVH walk of accel/traverse.py, as in the program.

`precision.lower()` switches the closest hit's outputs to bfloat16: the
control that the benchmark's comparison has to fail.
"""
from __future__ import annotations

import torch

from .. import precision
from . import traverse
from ..ops.trace_any import any_hit
from ..ops.trace_closest import closest_hit
from .traverse import Hit


def scene_bounds(tg):
    """The scene box (bmin, bmax) of a treelet table."""
    return torch.amin(tg.bmin, dim=0), torch.amax(tg.bmax, dim=0)


def _windows(o, min_t, max_t):
    b = o.shape[0]
    mn = torch.as_tensor(min_t, dtype=torch.float32, device=o.device)
    mx = torch.as_tensor(max_t, dtype=torch.float32, device=o.device)
    return mn.expand(b).contiguous(), mx.expand(b).contiguous()


def trace_closest(scene, o, d, min_t, max_t) -> Hit:
    """Closest hit of (B,) rays; min_t / max_t are (B,) tensors or floats."""
    tg = getattr(scene, "treelets", None)
    if tg is None:
        h = traverse.trace_closest(scene.geom, o, d, min_t, max_t)
        t, tri, u, v = h.t, h.tri, h.u, h.v
    else:
        mn, mx = _windows(o, min_t, max_t)
        t, tri, u, v = closest_hit(tg, o.contiguous(), d.contiguous(), mn, mx)
    t, u, v = (precision.hit(x) for x in (t, u, v))
    return Hit(t=t, tri=tri, u=u, v=v, valid=tri >= 0)


def trace_any(scene, o, d, min_t, max_t):
    """(B,) occlusion flags of segments; dead lanes are unoccluded."""
    if getattr(scene, "treelets", None) is None:
        return traverse.trace_any(scene.geom, o, d, min_t, max_t)
    mn, mx = _windows(o, min_t, max_t)
    return any_hit(scene.treelets_any, o.contiguous(), d.contiguous(), mn, mx)
