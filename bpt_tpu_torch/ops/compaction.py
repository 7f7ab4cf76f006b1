"""Live-lane compaction for trace batches (port of
bpt_tpu/ops/compaction.py).

BDPT's connection batches are mostly dead lanes (segments already known
to contribute nothing are traced as degenerate, max_t < min_t).
`compact_rays` packs the live lanes to the front of the batch, grouped by
a spatial cluster key, so that on the GPU whole warps of dead lanes exit
at once and neighbouring threads trace neighbouring rays.  The batch keeps
its size; the trailing lanes are the dead ones, moved whole.

The partition is one stable sort of a single int64 key plus gathers:

    key = cluster * B + i   (live lane i)
    key = n_clusters * B + i (dead lane i)

so live lanes order by cluster and, within a cluster, by original index.
The reference's sort-with-payload and its chunked sorts work around the
TPU's slow gathers and are not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CompactPlan(NamedTuple):
    """Mapping between the original batch and its compacted layout."""

    orig_idx: torch.Tensor  # (B,) int64: original index of compacted lane i
    valid: torch.Tensor     # (B,) bool: lane was live, in ORIGINAL order


def _cells(p, bmin, inv, n):
    """Per-axis cell index in [0, n), clamped before the int conversion
    so far-away points cannot overflow it."""
    return torch.clamp((p - bmin) * inv * n, 0.0, n - 1.0).long()


def _segment_cluster(o, end, bounds):
    """Cluster id in [0, 256) of a shadow segment: 64 cells of the light
    endpoint (light vertices are spatially random across lanes) times a
    coarse 2x2 split of the origin (eye vertices are already pixel-major
    coherent)."""
    bmin, bmax = bounds
    inv = 1.0 / torch.clamp_min(bmax - bmin, 1e-6)
    ce = _cells(end, bmin, inv, 4)
    c_end = (ce[:, 0] * 4 + ce[:, 1]) * 4 + ce[:, 2]
    co = _cells(o, bmin, inv, 2)
    c_o = co[:, 0] * 2 + co[:, 1]
    return c_end * 4 + c_o, 256


def _ray_cluster(o, d, bounds, n=4):
    """Cluster id of a closest-hit ray: origin cell (n^3) x direction
    octant (8), restoring direction coherence after diffuse bounces."""
    bmin, bmax = bounds
    inv = 1.0 / torch.clamp_min(bmax - bmin, 1e-6)
    q = _cells(o, bmin, inv, n)
    c_o = (q[:, 0] * n + q[:, 1]) * n + q[:, 2]
    oct_ = ((d[:, 0] >= 0).long() * 4 + (d[:, 1] >= 0).long() * 2
            + (d[:, 2] >= 0).long())
    return c_o * 8 + oct_, n * n * n * 8


def compact_rays(o, d, min_t, max_t, bounds=None, kind="segment"):
    """Stably pack live lanes (max_t >= min_t) to the batch front.

    min_t / max_t: (B,) tensors or Python floats.  bounds: optional
    (bmin, bmax) scene box; when given, live lanes group by
    `_ray_cluster` (kind="ray") or `_segment_cluster` (kind="segment").
    Returns (o_c, d_c, min_c, max_c, plan), all of the original size B.
    """
    b = o.shape[0]
    dev = o.device
    min_b = torch.as_tensor(min_t, dtype=torch.float32, device=dev).expand(b)
    max_b = torch.as_tensor(max_t, dtype=torch.float32, device=dev).expand(b)
    valid = max_b >= min_b
    iota = torch.arange(b, dtype=torch.int64, device=dev)
    if bounds is not None:
        if kind == "ray":
            cluster, n_cl = _ray_cluster(o, d, bounds)
        else:
            cluster, n_cl = _segment_cluster(o, o + d * max_b[:, None],
                                             bounds)
        key = torch.where(valid, cluster * b + iota, n_cl * b + iota)
    else:
        key = torch.where(valid, iota, iota + b)
    _, orig_idx = torch.sort(key, stable=True)
    return (o[orig_idx], d[orig_idx], min_b[orig_idx].contiguous(),
            max_b[orig_idx].contiguous(), CompactPlan(orig_idx, valid))


def uncompact(x_c, plan: CompactPlan, fill):
    """Restore one compacted (B,) array to the original lane order; dead
    lanes receive `fill`."""
    (x,) = uncompact_many((x_c,), plan, (fill,))
    return x


def uncompact_many(xs_c, plan: CompactPlan, fills):
    """Restore several (B,) arrays to the original lane order."""
    out = []
    for x_c, fill in zip(xs_c, fills):
        if x_c.ndim != 1:
            raise ValueError(f"uncompact needs (B,) columns, got {x_c.shape}")
        x = torch.empty_like(x_c)
        x[plan.orig_idx] = x_c
        out.append(torch.where(plan.valid, x,
                               torch.full_like(x, fill)))
    return tuple(out)
