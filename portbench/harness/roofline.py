"""The trace kernels' roofline: the least time the card could take for a
closest-hit or any-hit call, from the work its inputs need.

`treelet_sizes`, `treelet_counts` and `trace_bound` are frozen copies of
chip_smoke.py's (the bound the port's kernel table is measured against),
computed here on the reference's own treelet table, so that a new kernel,
route or table in the port changes the time and never the work.  The
peaks are an H100 SXM's at 700 W: 67 TFLOP/s FP32 outside the tensor
cores and 3.35 TB/s of HBM3.

`probe_*` draw the inputs of the two roofline metrics from the seed, at
the cell's shapes, time the port's routing entries (`accel.api.
trace_closest` / `trace_any`, compaction included) on them with CUDA
events, and return the share of the bound in percent.
"""
from __future__ import annotations

import torch

from ..reference.bpt.ops.intersect import SLAB_ELEMS, slab

OPS_SLAB = 28
OPS_MT = {"closest": 56, "any": 54}
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
REPS = 5


def treelet_sizes(tg):
    """(NT,) int64: the triangles of each treelet, its slots that are not
    all-zero pads."""
    return (tg.block != 0).any(dim=1).sum(dim=1)


def treelet_counts(tg, o, d, mn, mx, lanes, limit=None):
    """For each lane of the index tensor `lanes`: the number of treelets
    whose box its ray overlaps (with entry < limit[lane] when `limit` is
    given) and the triangles they hold; and which treelets any of these
    lanes overlaps.  Plain PyTorch, at most SLAB_ELEMS (lane, treelet)
    pairs a step."""
    nt = tg.bmin.shape[0]
    sizes = treelet_sizes(tg)
    count = torch.zeros(lanes.shape, dtype=torch.int64, device=o.device)
    tris = torch.zeros(lanes.shape, dtype=torch.int64, device=o.device)
    used = torch.zeros((nt,), dtype=torch.bool, device=o.device)
    step = max(1, SLAB_ELEMS // nt)
    for s in range(0, lanes.numel(), step):
        ln = lanes[s:s + step]
        mask, entry = slab(tg.bmin, tg.bmax, o[ln], d[ln], mn[ln], mx[ln])
        if limit is not None:
            mask &= entry < limit[ln, None]
        count[s:s + step] = mask.sum(1)
        tris[s:s + step] = torch.where(mask, sizes, 0).sum(1)
        used |= mask.any(0)
        del mask, entry
    return count, tris, used


def trace_bound(tg, args, kind, result):
    """The least time the card could take for one closest-hit (`kind`
    "closest", `result` (t, tri, u, v)) or any-hit ("any", `result` the
    flags) call on `args`: max(FP32 operations / PEAK_FP32_OPS, bytes /
    PEAK_BYTES), with the work these inputs need at treelet granularity.
    Closest hit: a live lane needs every treelet it overlaps with entry
    below its final t.  Any hit: an occluded lane one treelet (of the
    table's mean size), an open lane every treelet it overlaps.  A needed
    treelet costs one slab test and one triangle test for each of its
    triangles (pad slots, which hold none, cost nothing).  Bytes: each
    lane's ray (32 B) read and its result written once, and the box and
    triangles of every treelet that a closest-hit or open lane needs read
    once (an occluded lane's one treelet is left out: which one it is
    depends on the order)."""
    o, d, mn, mx = args
    b = o.shape[0]
    live = mx >= mn
    sizes = treelet_sizes(tg)
    if kind == "closest":
        lanes = torch.nonzero(live).squeeze(1)
        count, tris, used = treelet_counts(tg, o, d, mn, mx, lanes,
                                           limit=result[0])
        n, n_tris = int(count.sum()), int(tris.sum())
        out_bytes, tri_bytes = 16, 9 * 4 + 4
    else:
        lanes = torch.nonzero(live & ~result).squeeze(1)
        count, tris, used = treelet_counts(tg, o, d, mn, mx, lanes)
        occluded = int((live & result).sum())
        n = int(count.sum()) + occluded
        n_tris = int(tris.sum()) + round(occluded * float(sizes.double()
                                                            .mean()))
        out_bytes, tri_bytes = 1, 9 * 4
    ops = n * OPS_SLAB + n_tris * OPS_MT[kind]
    nbytes = (b * (32 + out_bytes) + int(used.sum()) * 6 * 4
              + int(sizes[used].sum()) * tri_bytes)
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "fp32_ops": ops, "bytes": nbytes}


def device_ms(fn, reps=REPS):
    """Mean device time of fn() in ms over `reps` calls after a first,
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _dirs(gen, n, device):
    d = torch.randn((n, 3), generator=gen, device=device)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def camera_rays(ref_scene, cam, lanes, gen, device):
    """`lanes` jittered camera rays, pixel by pixel in turn (the cell's
    primary batch: W*H pixels times the samples of a batch)."""
    from ..reference.bpt.core.camera import generate_rays

    npix = cam.width * cam.height
    pix = torch.arange(lanes, device=device, dtype=torch.int32) % npix
    jitter = torch.rand((lanes, 2), generator=gen, device=device)
    o, d = generate_rays(cam.device_constants(device), cam.width,
                         cam.height, pix, jitter)
    return (o.contiguous(), d.contiguous(),
            torch.full((lanes,), 1.0, device=device),
            torch.full((lanes,), 1000.0, device=device))


def segments(ref_scene, n, live_frac, gen, device):
    """n shadow segments between surface points of the scene, a share
    `live_frac` of them live, as chip_smoke.py::k2_inputs draws them."""
    from ..reference.bpt.accel.api import trace_closest

    m = 1 << 18
    lo = torch.tensor([-0.99, 0.01, -0.99], device=device)
    hi = torch.tensor([0.99, 1.99, 0.99], device=device)
    pts = []
    for _ in range(2):
        o = lo + (hi - lo) * torch.rand((m, 3), generator=gen, device=device)
        d = _dirs(gen, m, device)
        h = trace_closest(ref_scene, o, d, 1e-8, float("inf"))
        pts.append((o + d * h.t[:, None])[h.valid])
    ia = torch.randint(0, pts[0].shape[0], (n,), generator=gen, device=device)
    ib = torch.randint(0, pts[1].shape[0], (n,), generator=gen, device=device)
    start, end = pts[0][ia], pts[1][ib]
    seg = end - start
    dist = torch.linalg.vector_norm(seg, dim=-1)
    d = seg / torch.clamp_min(dist, 1e-20)[:, None]
    live = torch.rand((n,), generator=gen, device=device) < live_frac
    max_t = torch.where(live, dist - 1e-5, torch.full_like(dist, -1.0))
    return (start.contiguous(), d.contiguous(),
            torch.full((n,), 1e-8, device=device), max_t)


def share(kind, prog_scene, ref_scene, args) -> dict:
    """The port's routing entry on `args`, timed, against the bound on the
    reference's table: {"pct", "ms", "bound_ms", "bound_by"}."""
    from bpt_tpu_torch.accel import api as prog_api

    from ..reference.bpt.ops.trace_any import any_hit
    from ..reference.bpt.ops.trace_closest import closest_hit

    if kind == "closest":
        ms = device_ms(lambda: prog_api.trace_closest(prog_scene, *args))
        result = closest_hit(ref_scene.treelets, *args)
    else:
        ms = device_ms(lambda: prog_api.trace_any(prog_scene, *args))
        result = any_hit(ref_scene.treelets_any, *args)
    tg = ref_scene.treelets if kind == "closest" else ref_scene.treelets_any
    bound = trace_bound(tg, args, kind, result)
    return {"pct": 100.0 * bound["bound_ms"] / ms, "ms": ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
