"""The kernel table of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from bpt_tpu_torch/csrc/, the seven trace
kernels, G1 (the gathers' backward) and R1 (threefry, the RNG), prints
the ptxas report of each (registers against its launch bounds' budget,
spills), and checks each kernel against its plain PyTorch version at the
main paths' shapes, timing both:

  * `rng` (R1): each of fold_in, uniform1 and uniform2 one launch,
    bit-equal to its plain version, timed on 131,072 and 1,048,576 lanes
    whose inputs are not in L2, beside its byte bound;
  * `k1_closest_hit`, `k2_any_hit` (K1, K2): bit for bit and flag for
    flag on the bench scene (the procedural glass Cornell box, 19
    treelets) and on the same box with a subdiv-6 sphere (923
    treelets), at one batch's primary, walk and connect shapes (256x256,
    2 samples, rr_depth 8), with compaction's own time; `k1_k2_edges`:
    K1, K2, K6 and K7 on one ray, a ragged batch, all lanes dead, a
    table of one treelet and one of 2,048 with a full and many empty
    treelets;
  * `large_scene`: the box with a subdiv-7 sphere (327,704 triangles,
    3,656 treelets) written as TOML + OBJ/MTL and read back through
    `load_toml` and `load_scene`; `k3_closest_hit_stream`,
    `k4_any_hit_stream` (K3, K4) on it against their plain versions and
    K1's and K2's, and on the bench scene in groups of 8 against K1/K2;
  * `k5_closest_hit_full`, `k6_closest_hit_sweep`, `k7_any_hit_compact`
    (K5-K7) on both tables against their plain versions, K5 and K6 also
    against K1 and K7 against K2; K5 prints the share of lanes whose
    list overflowed;
  * `launches`: the main path, `render_chunk` at the bench settings
    (256x256, rr_depth 8, 2 samples a batch) for two batches on the bench
    scene and on the large scene, counted from a reset: rr_depth launches
    of K1 (K3) and one of K2 (K4) a batch, R1's launches, no other kernel
    and no plain version on CUDA tensors;
  * `gather` (G1): one config #5 descent step (1024x1024, 2 spp,
    rr_depth 2) counted from a reset (K1, K2 and G1 alone, no plain
    version on CUDA tensors); its G1 calls held to a float64 sum and to
    the plain version, bit-identical from call to call, timed beside the
    plain version and autograd's own backward of `table[ids]`.

Every timed trace call is printed beside its bound (`trace_bound`: the
FP32 operations and bytes that its inputs need, over the card's peak
rates) and its share of that bound.  One JSON line per phase, each with
its `elapsed_s`; then the card's `nvidia-smi` name and power limit, the
`kernels` line (one row a kernel: its launches a main-path batch, its
error against the plain version, ms, plain ms, bound ms), and
{"ok": true, "device": {...}}.  Any failed
check raises, so the exit code is not 0 and no result line is printed.
Without a CUDA device it exits with code 2.  JAX is never imported.

Renders through the kernels are checked by `pytest -m cuda`
(tests/test_torch_*cuda.py) and timed by portbench/; the `launches`
phase reads launch counts of the main path, not its image.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

SEED = 7
BENCH = dict(width=256, height=256, spp=16, rr_depth=8, sb=2)
LARGE = dict(sphere_subdiv=7, n_triangles=327_704, n_treelets=3_656)
# The second table of K5-K7: 29 runs of 32 treelets, whose packed rows
# do not fit in shared memory.
SUBDIV6 = dict(sphere_subdiv=6, n_treelets=923)
# The bench scene's 19 treelets in groups of 8: three groups, the last
# one ragged.
BENCH_CHUNK = 8
DEAD_FRAC_K1 = 0.10
LIVE_FRAC_K2 = 0.30
REPS = 5
# The bound of a trace call (trace_bound): FP32 operations of one slab
# test and of one Moeller-Trumbore test as csrc/intersect.cuh writes
# them, each add, subtract, multiply, divide, min, max and compare
# counting one (the window compares of each kind included), over the
# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet).  The
# kernels build with -fmad=false, so no FMA pairs a multiply with an
# add, and about half of the FP32 peak is the most they can reach.
OPS_SLAB = 28
OPS_MT = {"closest": 56, "any": 54}
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12


def emit(obj, t0=None):
    if t0 is not None:
        obj["elapsed_s"] = time.perf_counter() - t0
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_timed(fn, reps):
    """(the result of a first call of fn, the mean device time in ms of
    `reps` more calls, CUDA events)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def cuda_ms(fn, reps=REPS):
    """Mean device time of fn() in ms over `reps` calls, CUDA events,
    after one warm-up call."""
    return run_timed(fn, reps)[1]


def bench_scene(device, sphere_subdiv=3):
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    return cornell_box_scene(BENCH["width"], BENCH["height"], device=device,
                             right_object="glass_sphere",
                             sphere_subdiv=sphere_subdiv)


def _uniform(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def _random_dirs(gen, n, device):
    d = torch.randn((n, 3), generator=gen, device=device)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def k1_inputs(scene, cam, device):
    """The bench's primary rays (256x256 x 2 samples, the batch the
    primary trace gets) and 2B bounce-like rays (the walk trace's batch)
    from surface points in random directions; ~10% dead lanes."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.camera import generate_rays
    from bpt_tpu_torch.integrators.bdpt import _blocked_pixel_order

    w, h, sb = BENCH["width"], BENCH["height"], BENCH["sb"]
    cc = cam.device_constants(device)
    pix = _blocked_pixel_order(w, h, device)
    # Lane keys of the first sample batch, laid out as render_chunk does.
    skeys = rng.fold_in(rng.key(SEED, device)[None, :],
                        torch.arange(sb, device=device))
    keys = rng.fold_in(skeys[:, None, :], pix[None, :])
    keys = keys.transpose(0, 1).reshape(-1, 2)
    jitter = rng.uniform2(rng.lane_fold(keys, rng.PIXEL_JITTER))
    o, d = generate_rays(cc, w, h, pix.repeat_interleave(sb), jitter)
    b = o.shape[0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    prim = (o.contiguous(), d.contiguous(),
            torch.full((b,), 1.0, device=device),
            torch.where(_uniform(gen, b, device) < DEAD_FRAC_K1, -1.0,
                        1000.0).to(torch.float32))
    # Bounce origins: points inside the box, random directions.
    n = 2 * b
    lo = torch.tensor([-0.99, 0.01, -0.99], device=device)
    hi = torch.tensor([0.99, 1.99, 0.99], device=device)
    bo = lo + (hi - lo) * _uniform(gen, (n, 3), device)
    bd = _random_dirs(gen, n, device)
    bounce = (bo, bd, torch.full((n,), 1e-8, device=device),
              torch.where(_uniform(gen, n, device) < DEAD_FRAC_K1, -1.0,
                          float("inf")).to(torch.float32))
    return prim, bounce


def k2_inputs(scene, device, n):
    """n shadow segments between surface points of the scene (eye-side
    starts, light-side ends), ~70% dead, as in the mega-connect batch,
    compacted as `accel.api.trace_any` compacts them."""
    from bpt_tpu_torch.accel.api import scene_bounds, trace_closest
    from bpt_tpu_torch.ops.compaction import compact_rays

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    m = 1 << 18
    lo = torch.tensor([-0.99, 0.01, -0.99], device=device)
    hi = torch.tensor([0.99, 1.99, 0.99], device=device)
    pts = []
    for _ in range(2):
        o = lo + (hi - lo) * _uniform(gen, (m, 3), device)
        d = _random_dirs(gen, m, device)
        h = trace_closest(scene, o, d, 1e-8, float("inf"))
        pts.append((o + d * h.t[:, None])[h.valid])
    ia = torch.randint(0, pts[0].shape[0], (n,), generator=gen, device=device)
    ib = torch.randint(0, pts[1].shape[0], (n,), generator=gen, device=device)
    start, end = pts[0][ia], pts[1][ib]
    seg = end - start
    dist = torch.linalg.vector_norm(seg, dim=-1)
    d = seg / torch.clamp_min(dist, 1e-20)[:, None]
    live = _uniform(gen, n, device) < LIVE_FRAC_K2
    max_t = torch.where(live, dist - 1e-5, torch.full_like(dist, -1.0))
    segs = (start, d, torch.full((n,), 1e-8, device=device), max_t)
    o, d, mn, mx, _ = compact_rays(*segs,
                                   bounds=scene_bounds(scene.treelets_any))
    return segs, (o.contiguous(), d.contiguous(), mn, mx)


def compacted_k1_inputs(scene, cam, device):
    """k1_inputs compacted as `accel.api.trace_closest` compacts them:
    {"primary": (o, d, min_t, max_t), "walk": ...}, plus the raw rays."""
    from bpt_tpu_torch.accel.api import scene_bounds
    from bpt_tpu_torch.ops.compaction import compact_rays

    out, raw = {}, {}
    for name, rays in zip(("primary", "walk"), k1_inputs(scene, cam, device)):
        o, d, mn, mx, _ = compact_rays(*rays,
                                       bounds=scene_bounds(scene.treelets),
                                       kind="ray")
        out[name] = (o.contiguous(), d.contiguous(), mn, mx)
        raw[name] = rays
    return out, raw


def bit_mismatch(a, b):
    """Lanes where two float32 tensors differ bit for bit."""
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def closest_report(got, ref):
    """tri mismatches, t/u/v bit mismatches and max |error| over hits of
    a closest-hit result against a reference result."""
    hit = ref[1] >= 0
    err = max(float((got[i][hit] - ref[i][hit]).abs().max())
              if bool(hit.any()) else 0.0 for i in (0, 2, 3))
    return {"tri_mismatch": int((got[1] != ref[1]).sum()),
            "t_u_v_bit_mismatch": [bit_mismatch(got[i], ref[i])
                                   for i in (0, 2, 3)],
            "max_abs_err": err}


def treelet_counts(tg, o, d, mn, mx, lanes, limit=None):
    """For each lane of the index tensor `lanes`: the number of treelets
    whose box its ray overlaps (with entry < limit[lane] when `limit` is
    given) and the triangles they hold; and which treelets any of these
    lanes overlaps.  Plain PyTorch, at most SLAB_ELEMS (lane, treelet)
    pairs a step."""
    from bpt_tpu_torch.ops.intersect import SLAB_ELEMS, slab

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


def treelet_sizes(tg):
    """(NT,) int64: the triangles of each treelet, its slots that are not
    all-zero pads."""
    return (tg.block != 0).any(dim=1).sum(dim=1)


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
            "fp32_ops": ops, "bytes": nbytes, "treelets_needed": n,
            "triangles_needed": n_tris,
            "treelets_per_live_lane": n / max(int(live.sum()), 1),
            "treelets_any_lane_needs": int(used.sum()),
            "pad_slot_share": 1.0 - float(sizes.sum()) / tg.block.shape[0]
            / tg.block.shape[2]}


def with_bound(res, bound):
    """A timed result with its bound and the share of the bound it
    reaches (bound / time)."""
    return {**res, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "share_of_bound": bound["bound_ms"] / res["ms"],
            "bound_work": {k: v for k, v in bound.items()
                           if k not in ("bound_ms", "bound_by")}}


def ptxas_report(log):
    """{kernel entry: registers, static shared memory and spills} from
    the -Xptxas -v lines of the kernels' build."""
    rep, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", ln)
        if m:
            cur = rep.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_store_bytes"] = int(m.group(1))
            cur["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(m.group(1)) if m else 0
    return rep


# Registers a thread of K1-K4 may take: their launch bounds ask for two
# blocks of 384 threads on an SM of 65,536 registers.
REGISTER_BUDGET = 65_536 // (2 * 384)
# The same for the tile kernels K6 and K7: four blocks of 128 threads.
TILE_REGISTER_BUDGET = 65_536 // (4 * 128)
# The same for K5: two blocks of 256 threads.
FULL_REGISTER_BUDGET = 65_536 // (2 * 256)


def kernel_resources(info, kernel, budget=REGISTER_BUDGET):
    """The ptxas report of every entry whose name holds `kernel`, with
    what exceeds the launch bounds' register budget or spills said
    outright."""
    rep = {name: r for name, r in info["ptxas"].items() if kernel in name}
    if not rep:
        return "not reported: the library was built by an earlier process"
    over = [n for n, r in rep.items()
            if r.get("registers", 0) > budget
            or r.get("spill_store_bytes") or r.get("spill_load_bytes")]
    return {"entries": rep, "register_budget": budget,
            "over_budget_or_spilling": sorted(over)}


def phase_device():
    from bpt_tpu_torch.native import native
    from bpt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.library()
    ptxas = ptxas_report(lib.build_log)
    t1 = time.perf_counter()
    native.library()
    info = {
        "phase": "device",
        "nvidia_smi": nvidia_smi_line(),
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "kernel_build_s": t1 - t0,
        "native_build_s": time.perf_counter() - t1,
        "ptxas": ptxas,
    }
    emit(info, t0)
    return info


def phase_k1(tables, info):
    """K1 against its plain version, bit for bit, on each table
    (name, treelet table, (compacted rays, raw rays)) at the slice's
    closest-hit shapes; compaction's own time on the bench table."""
    from bpt_tpu_torch.ops.compaction import compact_rays
    from bpt_tpu_torch.accel.api import scene_bounds
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_plain

    t0 = time.perf_counter()
    out = {"phase": "k1_closest_hit", "nvidia_smi": info["nvidia_smi"],
           "ptxas": kernel_resources(info, "closest_hit_kernel")}
    timing = None
    failed = []
    for tname, tg, (compacted, raw_rays) in tables:
        for name, (o, d, mn, mx) in compacted.items():
            got = closest_hit(tg, o, d, mn, mx)
            ref = closest_hit_plain(tg, o, d, mn, mx)
            torch.cuda.synchronize()
            rep = closest_report(got, ref)
            res = {"n_treelets": tg.block.shape[0], "lanes": o.shape[0],
                   "live": int((mx >= mn).sum()),
                   "hits": int((ref[1] >= 0).sum()), **rep,
                   "ms": cuda_ms(lambda: closest_hit(tg, o, d, mn, mx)),
                   "plain_ms": cuda_ms(
                       lambda: closest_hit_plain(tg, o, d, mn, mx), reps=1)}
            if tname == "bench":
                res["compact_ms"] = cuda_ms(lambda: compact_rays(
                    *raw_rays[name], bounds=scene_bounds(tg), kind="ray"))
                raw = [x.contiguous() for x in raw_rays[name]]
                res["ms_uncompacted"] = cuda_ms(lambda: closest_hit(tg, *raw))
            key = name if tname == "bench" else f"{tname}_{name}"
            out[key] = with_bound(res, trace_bound(tg, (o, d, mn, mx),
                                                   "closest", ref))
            if rep["tri_mismatch"] or any(rep["t_u_v_bit_mismatch"]):
                failed.append(key)
            if key == "walk":
                timing = out[key]
    emit(out, t0)
    if failed:
        raise AssertionError(f"K1 disagrees with its plain version on "
                             f"{failed}")
    return timing


def phase_k2(tables, info):
    """K2 against its plain version, flag for flag, on each table (name,
    treelet table, (raw segments, compacted segments)) at the slice's
    any-hit shape."""
    from bpt_tpu_torch.accel.api import scene_bounds
    from bpt_tpu_torch.ops.compaction import compact_rays
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_plain

    t0 = time.perf_counter()
    out = {"phase": "k2_any_hit", "nvidia_smi": info["nvidia_smi"],
           "ptxas": kernel_resources(info, "any_hit_kernel")}
    failed = []
    for tname, tg, (raw_segs, (o, d, mn, mx)) in tables:
        got = any_hit(tg, o, d, mn, mx)
        ref = any_hit_plain(tg, o, d, mn, mx)
        torch.cuda.synchronize()
        res = {"n_treelets": tg.block.shape[0], "lanes": o.shape[0],
               "live": int((mx >= mn).sum()), "occluded": int(ref.sum()),
               "flag_mismatch": int((got != ref).sum()),
               # The flags as 0/1 integers: max |kernel - plain| is 0 or 1.
               "max_abs_err": float((got.int() - ref.int()).abs().max()),
               "ms": cuda_ms(lambda: any_hit(tg, o, d, mn, mx)),
               "plain_ms": cuda_ms(lambda: any_hit_plain(tg, o, d, mn, mx),
                                   reps=1)}
        if tname == "bench":
            res["compact_ms"] = cuda_ms(lambda: compact_rays(
                *raw_segs, bounds=scene_bounds(tg)))
            res["ms_uncompacted"] = cuda_ms(lambda: any_hit(tg, *raw_segs))
        out[tname] = with_bound(res, trace_bound(tg, (o, d, mn, mx), "any",
                                                 ref))
        if res["flag_mismatch"]:
            failed.append(tname)
    emit(out, t0)
    if failed:
        raise AssertionError(f"K2 disagrees with its plain version on "
                             f"{failed}")
    return out["bench"]


def _edge_rays(n, seed, device, segment, live_frac=0.6):
    """n rays from inside the box in random directions, `live_frac` of
    them live; finite windows with `segment`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lo = torch.tensor([-0.95, 0.05, -0.95], device=device)
    hi = torch.tensor([0.95, 1.95, 0.95], device=device)
    o = lo + (hi - lo) * _uniform(gen, (n, 3), device)
    d = _random_dirs(gen, n, device)
    far = (_uniform(gen, n, device) * 3.0 if segment
           else torch.full((n,), float("inf"), device=device))
    live = _uniform(gen, n, device) < live_frac
    return (o, d, torch.full((n,), 1e-8, device=device),
            torch.where(live, far, torch.full_like(far, -1.0)))


def edge_tables(tg, max_treelets):
    """Tables at the edges of what K1 and K2 take, cut from the treelet
    table `tg`: one treelet; and `max_treelets` of them, the first two
    merged into one of K full slots (the second one's triangles repeated
    as far as needed), the rest of `tg` behind it, then treelets that
    hold no triangle in boxes inside the scene."""
    nt, _, k = tg.block.shape
    fields = type(tg)
    one = fields(*(x[5:6].contiguous() for x in tg))
    filled = (tg.block != 0).any(dim=1)  # (NT, K)
    n0 = int(filled[0].sum())
    take = torch.nonzero(filled[1]).squeeze(1)
    take = take.repeat(-(-(k - n0) // take.numel()))[:k - n0]
    full_block = torch.cat([tg.block[0, :, :n0], tg.block[1][:, take]], dim=1)
    full_index = torch.cat([tg.tri_index[0, :n0], tg.tri_index[1, take]])
    n_empty = max_treelets - (nt - 1)
    gen = torch.Generator(device=tg.block.device).manual_seed(SEED + 2)
    lo = torch.amin(tg.bmin, dim=0)
    size = torch.amax(tg.bmax, dim=0) - lo
    corner = lo + size * 0.8 * _uniform(gen, (n_empty, 3), tg.block.device)
    pad = int(tg.tri_index.max())
    limit = fields(
        bmin=torch.cat([torch.minimum(tg.bmin[0], tg.bmin[1])[None],
                        tg.bmin[2:], corner]).contiguous(),
        bmax=torch.cat([torch.maximum(tg.bmax[0], tg.bmax[1])[None],
                        tg.bmax[2:], corner + 0.2 * size]).contiguous(),
        tri_index=torch.cat([full_index[None], tg.tri_index[2:],
                             torch.full((n_empty, k), pad, dtype=torch.int32,
                                        device=tg.block.device)]).contiguous(),
        block=torch.cat([full_block[None], tg.block[2:],
                         tg.block.new_zeros((n_empty, 9, k))]).contiguous())
    return {"one_treelet": one, f"limit_{max_treelets}": limit}


def phase_k12_edges(scene, device):
    """K1 and K2 against their plain versions on edge inputs: one ray, a
    batch that is no multiple of the block, all lanes dead, a table of one
    treelet, and the largest table the kernels take (2,048 treelets, one
    with all K slots filled, most with none, its triangle rows read from
    global memory where the bench table's sit in shared memory).  K6 and
    K7, which take the same tables, run the same inputs against their
    plain versions, K6's t against K1's and K7's flags against K2's."""
    from bpt_tpu_torch.accel.treelets import packed_triangles, \
        triangle_counts
    from bpt_tpu_torch.ops.intersect import MAX_TREELETS
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_compact, \
        any_hit_compact_plain, any_hit_plain
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_plain, closest_hit_sweep, closest_hit_sweep_plain

    t0 = time.perf_counter()
    tg = scene.treelets
    tables = {"bench": tg, **edge_tables(tg, MAX_TREELETS)}
    out = {"phase": "k1_k2_edges", "tables": {}}
    for name, t in tables.items():
        counts = triangle_counts(t)
        out["tables"][name] = {
            "n_treelets": t.block.shape[0],
            "packed_rows": packed_triangles(t)[0].shape[0],
            "count_min": int(counts.min()), "count_max": int(counts.max())}
    cases = [("bench", 1, 0.6), ("bench", 1000, 0.6), ("bench", 5000, 0.0)]
    cases += [(name, 50_000, 0.6) for name in tables if name != "bench"]
    failed = []
    for i, (name, n, live_frac) in enumerate(cases):
        t = tables[name]
        res = {}
        rays = _edge_rays(n, SEED + 10 + i, device, False, live_frac)
        k1 = closest_hit(t, *rays)
        rep = closest_report(k1, closest_hit_plain(t, *rays))
        res["k1"] = {"hits": int((closest_hit_plain(t, *rays)[1] >= 0).sum()),
                     "tri_mismatch": rep["tri_mismatch"],
                     "t_u_v_bit_mismatch": rep["t_u_v_bit_mismatch"]}
        k6 = closest_hit_sweep(t, *rays)
        rep6 = closest_report(k6, closest_hit_sweep_plain(t, *rays))
        res["k6"] = {"tri_mismatch": rep6["tri_mismatch"],
                     "t_u_v_bit_mismatch": rep6["t_u_v_bit_mismatch"],
                     "t_bit_mismatch_vs_k1": bit_mismatch(k6[0], k1[0])}
        segs = _edge_rays(n, SEED + 30 + i, device, True, live_frac)
        ref = any_hit_plain(t, *segs)
        k2 = any_hit(t, *segs)
        res["k2"] = {"occluded": int(ref.sum()),
                     "flag_mismatch": int((k2 != ref).sum())}
        k7 = any_hit_compact(t, *segs)
        res["k7"] = {
            "flag_mismatch": int((k7 != any_hit_compact_plain(t, *segs))
                                 .sum()),
            "flag_mismatch_vs_k2": int((k7 != k2).sum())}
        out[f"{name}_b{n}_live{live_frac}"] = res
        if (rep["tri_mismatch"] or any(rep["t_u_v_bit_mismatch"])
                or res["k2"]["flag_mismatch"] or rep6["tri_mismatch"]
                or any(rep6["t_u_v_bit_mismatch"])
                or res["k6"]["t_bit_mismatch_vs_k1"]
                or any(res["k7"].values())):
            failed.append((name, n, live_frac))
    torch.cuda.synchronize()
    emit(out, t0)
    limit = out["tables"][f"limit_{MAX_TREELETS}"]
    if (limit["n_treelets"], limit["count_min"], limit["count_max"]) \
            != (MAX_TREELETS, 0, tg.block.shape[2]):
        raise AssertionError(f"the edge table is not the one described: "
                             f"{limit}")
    if failed:
        raise AssertionError(f"K1, K2, K6 or K7 disagrees on edge inputs "
                             f"{failed}")


def phase_large_scene(device):
    """The large scene as a user brings it: written as TOML + OBJ/MTL to a
    temporary directory, then read back through load_toml and load_scene
    (the native BVH builder, which tests/test_torch_native.py holds equal
    to the numpy one)."""
    from bpt_tpu_torch.scene.export import export_cornell_box
    from bpt_tpu_torch.scene.scene import load_scene
    from bpt_tpu_torch.scene.toml_config import load_toml

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        toml_path = export_cornell_box(
            tmp, width=BENCH["width"], height=BENCH["height"],
            spp=BENCH["spp"], rr_depth=BENCH["rr_depth"],
            right_object="glass_sphere",
            sphere_subdiv=LARGE["sphere_subdiv"])
        t1 = time.perf_counter()
        cfg = load_toml(toml_path)
        obj_bytes = os.path.getsize(cfg.obj_file)
        scene, meta = load_scene(cfg.obj_file, device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    nt = scene.treelets.block.shape[0]
    out = {"phase": "large_scene", "config": "glass cbox, sphere subdiv 7, "
           "scene file -> load_toml -> load_scene",
           "n_triangles": meta.n_triangles, "n_treelets": nt,
           "n_treelets_any": scene.treelets_any.block.shape[0],
           "obj_bytes": obj_bytes, "write_s": t1 - t0, "load_s": t2 - t1,
           "toml": {"width": cfg.width, "height": cfg.height,
                    "spp": cfg.spp, "rr_depth": cfg.rr_depth}}
    emit(out, t0)
    if (meta.n_triangles, nt) != (LARGE["n_triangles"], LARGE["n_treelets"]):
        raise AssertionError("the large scene is not the 327,704-triangle, "
                             "3,656-treelet glass box")
    return scene, meta, cfg


def phase_k3(large, large_rays, bench, bench_rays, info):
    """K3 on the large scene at the slice's closest-hit shapes, bit for
    bit against its plain version and against K1's plain version (the
    same function); on the bench scene in groups of 8, bit for bit
    against its plain version and K1."""
    from bpt_tpu_torch.ops.intersect import STREAM_CHUNK
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_plain, closest_hit_stream, closest_hit_stream_plain

    t0 = time.perf_counter()
    out = {"phase": "k3_closest_hit_stream", "chunk_nt": STREAM_CHUNK,
           "nvidia_smi": info["nvidia_smi"],
           "ptxas": kernel_resources(info, "closest_hit_stream_kernel")}
    tg = large.treelets
    timing = None
    failed = []
    for name, args in large_rays[0].items():
        got = closest_hit_stream(tg, *args, STREAM_CHUNK)
        tp = time.perf_counter()
        ref = closest_hit_stream_plain(tg, *args, STREAM_CHUNK)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - tp
        rep = closest_report(got, ref)
        vs_k1 = closest_report(got, closest_hit_plain(tg, *args))
        k_ms = cuda_ms(lambda: closest_hit_stream(tg, *args, STREAM_CHUNK))
        p_ms = cuda_ms(lambda: closest_hit_stream_plain(tg, *args,
                                                        STREAM_CHUNK), reps=1)
        res = out["large_" + name] = with_bound(
            {"lanes": args[0].shape[0],
             "live": int((args[3] >= args[2]).sum()),
             "hits": int((ref[1] >= 0).sum()), **rep,
             "tri_mismatch_vs_k1": vs_k1["tri_mismatch"],
             "t_u_v_bit_mismatch_vs_k1": vs_k1["t_u_v_bit_mismatch"],
             "ms": k_ms, "plain_ms": p_ms, "plain_first_call_s": plain_wall},
            trace_bound(tg, args, "closest", ref))
        if (rep["tri_mismatch"] or any(rep["t_u_v_bit_mismatch"])
                or vs_k1["tri_mismatch"]
                or any(vs_k1["t_u_v_bit_mismatch"])):
            failed.append("large_" + name)
        if name == "walk":
            timing = res

    tg = bench.treelets
    for name, args in bench_rays[0].items():
        got = closest_hit_stream(tg, *args, BENCH_CHUNK)
        plain = closest_hit_stream_plain(tg, *args, BENCH_CHUNK)
        k1 = closest_hit(tg, *args)
        torch.cuda.synchronize()
        rep = {"vs_plain": closest_report(got, plain),
               "vs_k1": closest_report(got, k1)}
        out[f"bench_{name}_chunk{BENCH_CHUNK}"] = rep
        if any(r["tri_mismatch"] or any(r["t_u_v_bit_mismatch"])
               for r in rep.values()):
            failed.append(f"bench_{name}")
    emit(out, t0)
    if failed:
        raise AssertionError(f"K3 disagrees with its plain version or K1 "
                             f"on {failed}")
    return timing


def phase_k4(large, large_segs, bench, bench_segs, info):
    """K4 against its plain version and K2's plain version on the large
    scene's connect batch; on the bench scene in groups of 8, against
    its plain version and K2."""
    from bpt_tpu_torch.ops.intersect import STREAM_CHUNK
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_plain, \
        any_hit_stream, any_hit_stream_plain

    t0 = time.perf_counter()
    tg = large.treelets_any
    o, d, mn, mx = large_segs[1]
    got = any_hit_stream(tg, o, d, mn, mx, STREAM_CHUNK)
    tp = time.perf_counter()
    ref = any_hit_stream_plain(tg, o, d, mn, mx, STREAM_CHUNK)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - tp
    bad = int((got != ref).sum())
    bad_k2 = int((got != any_hit_plain(tg, o, d, mn, mx)).sum())
    flag_err = float((got.int() - ref.int()).abs().max())
    k_ms = cuda_ms(lambda: any_hit_stream(tg, o, d, mn, mx, STREAM_CHUNK))
    p_ms = cuda_ms(lambda: any_hit_stream_plain(tg, o, d, mn, mx,
                                                STREAM_CHUNK), reps=1)
    res = with_bound(
        {"lanes": o.shape[0], "live": int((mx >= mn).sum()),
         "occluded": int(ref.sum()), "flag_mismatch": bad,
         "flag_mismatch_vs_k2_plain": bad_k2, "ms": k_ms, "plain_ms": p_ms,
         "plain_first_call_s": plain_wall, "max_abs_err": flag_err},
        trace_bound(tg, (o, d, mn, mx), "any", ref))
    out = {"phase": "k4_any_hit_stream", "chunk_nt": STREAM_CHUNK,
           "nvidia_smi": info["nvidia_smi"],
           "ptxas": kernel_resources(info, "any_hit_stream_kernel"),
           "large": res}
    tg = bench.treelets_any
    args = bench_segs[1]
    got_b = any_hit_stream(tg, *args, BENCH_CHUNK)
    plain_b = any_hit_stream_plain(tg, *args, BENCH_CHUNK)
    k2 = any_hit(tg, *args)
    torch.cuda.synchronize()
    out[f"bench_chunk{BENCH_CHUNK}"] = {
        "lanes": args[0].shape[0], "occluded": int(k2.sum()),
        "flag_mismatch_vs_plain": int((got_b != plain_b).sum()),
        "flag_mismatch_vs_k2": int((got_b != k2).sum())}
    emit(out, t0)
    if (bad or bad_k2 or int((got_b != plain_b).sum())
            or int((got_b != k2).sum())):
        raise AssertionError("K4 disagrees with its plain version or K2")
    return res


def phase_closest_kernel(phase, kernel, plain, tables, exact_vs_k1,
                         ptxas=None):
    """A closest-hit kernel (K5 or K6) against its plain version, bit for
    bit, and against K1 (the same t on every lane; with `exact_vs_k1` the
    same tri too) on each table at the slice's closest-hit shapes.  For
    K5, the share of live lanes whose list overflowed (the kernel's own
    count, `closest_hit_full.overflow_lanes`)."""
    from bpt_tpu_torch.ops.trace_closest import closest_hit

    t0 = time.perf_counter()
    out = {"phase": phase}
    if ptxas is not None:
        out["ptxas"] = ptxas
    timing = None
    failed = []
    for tname, tg, rays in tables:
        for name, args in rays.items():
            got, k_ms = run_timed(lambda: kernel(tg, *args), REPS)
            ref, p_ms = run_timed(lambda: plain(tg, *args), 1)
            k1, k1_ms = run_timed(lambda: closest_hit(tg, *args), REPS)
            rep = closest_report(got, ref)
            same = got[1] == k1[1]
            res = with_bound(
                {"n_treelets": tg.block.shape[0], "lanes": args[0].shape[0],
                 "live": int((args[3] >= args[2]).sum()),
                 "hits": int((ref[1] >= 0).sum()), **rep, "ms": k_ms,
                 "plain_ms": p_ms, "k1_ms": k1_ms,
                 "t_bit_mismatch_vs_k1": bit_mismatch(got[0], k1[0]),
                 # t is K1's on every lane, so each of these lanes is a
                 # tie at exactly the same t.
                 "tri_mismatch_vs_k1_exact_t_ties": int((~same).sum()),
                 "u_v_bit_mismatch_vs_k1_same_tri": [
                     bit_mismatch(got[i][same], k1[i][same])
                     for i in (2, 3)]},
                trace_bound(tg, args, "closest", ref))
            overflow = getattr(kernel, "overflow_lanes", None)
            if overflow is not None:
                res["overflow_lanes"] = int(overflow)
                res["overflow_share"] = int(overflow) / max(res["live"], 1)
            out[f"{tname}_{name}"] = res
            if (rep["tri_mismatch"] or any(rep["t_u_v_bit_mismatch"])
                    or res["t_bit_mismatch_vs_k1"]
                    or any(res["u_v_bit_mismatch_vs_k1_same_tri"])
                    or (exact_vs_k1
                        and res["tri_mismatch_vs_k1_exact_t_ties"])):
                failed.append(f"{tname}_{name}")
            if (tname, name) == ("bench", "walk"):
                timing = res
    emit(out, t0)
    if failed:
        raise AssertionError(f"{phase} disagrees on {failed}")
    return timing


def phase_k7(tables, info):
    """K7 against its plain version and K2, flag for flag, on each table
    at the slice's any-hit shape."""
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_compact, \
        any_hit_compact_plain

    t0 = time.perf_counter()
    out = {"phase": "k7_any_hit_compact",
           "ptxas": kernel_resources(info, "any_hit_compact_kernel",
                                     TILE_REGISTER_BUDGET)}
    timing = None
    failed = []
    for tname, tg, (o, d, mn, mx) in tables:
        got, k_ms = run_timed(lambda: any_hit_compact(tg, o, d, mn, mx), REPS)
        ref, p_ms = run_timed(lambda: any_hit_compact_plain(tg, o, d, mn, mx),
                              1)
        k2, k2_ms = run_timed(lambda: any_hit(tg, o, d, mn, mx), REPS)
        bad = int((got != ref).sum())
        res = with_bound(
            {"n_treelets": tg.block.shape[0], "lanes": o.shape[0],
             "live": int((mx >= mn).sum()), "occluded": int(ref.sum()),
             "flag_mismatch": bad,
             "flag_mismatch_vs_k2": int((got != k2).sum()),
             "max_abs_err": float((got.int() - ref.int()).abs().max()),
             "ms": k_ms, "plain_ms": p_ms, "k2_ms": k2_ms},
            trace_bound(tg, (o, d, mn, mx), "any", ref))
        out[tname] = res
        if bad or res["flag_mismatch_vs_k2"]:
            failed.append(tname)
        if tname == "bench":
            timing = res
    emit(out, t0)
    if failed:
        raise AssertionError(f"K7 disagrees on {failed}")
    return timing


def phase_subdiv6(device):
    t0 = time.perf_counter()
    scene, meta, _ = bench_scene(device, SUBDIV6["sphere_subdiv"])
    torch.cuda.synchronize()
    nt = scene.treelets.block.shape[0]
    emit({"phase": "subdiv6_scene", "n_triangles": meta.n_triangles,
          "n_treelets": nt}, t0)
    if nt != SUBDIV6["n_treelets"]:
        raise AssertionError(f"the subdiv-6 glass box has {nt} treelets, "
                             f"not {SUBDIV6['n_treelets']}")
    return scene


# The main path's launches (phase launches): render_chunk at BENCH's
# settings for LAUNCH_BATCHES batches of BENCH['sb'] samples.
LAUNCH_BATCHES = 2


def phase_launches(device, paths):
    """render_chunk, the main path, at BENCH's settings (256x256, rr_depth
    8, 2 samples a batch) for LAUNCH_BATCHES batches on each of `paths`
    ((name, scene, camera, (its closest-hit kernel, its any-hit
    kernel))), with the counts reset just before.  Each batch launches the
    closest-hit kernel rr_depth times (the primaries and rr_depth - 1
    walk depths) and the any-hit kernel once (the connect); R1 launches;
    no other kernel, and no plain version on CUDA tensors.  The image is
    not read.  Returns {name: launches a batch by kernel, R1's as
    'threefry'}."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk
    from bpt_tpu_torch.ops import threefry

    t0 = time.perf_counter()
    spp = LAUNCH_BATCHES * BENCH["sb"]
    cfg = BDPTConfig(BENCH["width"], BENCH["height"], spp=spp,
                     rr_depth=BENCH["rr_depth"])
    key = rng.key(SEED, device)
    out, per_batch, bad = {}, {}, []
    for name, scene, cam, (closest, any_hit) in paths:
        cc = cam.device_constants(device)
        torch.cuda.synchronize()
        reset_counts()
        threefry.threefry_cuda.launches = 0
        render_chunk(scene, cc, cfg, key, spp,
                     samples_per_batch=BENCH["sb"])
        torch.cuda.synchronize()
        launches, plain_calls = read_counts()
        launches["threefry"] = threefry.threefry_cuda.launches
        per_batch[name] = {k: n / LAUNCH_BATCHES
                           for k, n in launches.items()}
        out[name] = {"launches": launches,
                     "plain_calls_on_cuda": plain_calls}
        if (plain_calls or not launches["threefry"]
                or launches[closest] != BENCH["rr_depth"] * LAUNCH_BATCHES
                or launches[any_hit] != LAUNCH_BATCHES
                or any(n for k, n in launches.items()
                       if k not in (closest, any_hit, "threefry"))):
            bad.append(name)
    emit({"phase": "launches", "config": f"render_chunk {BENCH['width']}x"
          f"{BENCH['height']} spp {spp} rr{BENCH['rr_depth']} sb "
          f"{BENCH['sb']}", "batches": LAUNCH_BATCHES, **out,
          "launches_per_batch": per_batch}, t0)
    if bad:
        raise AssertionError(f"launches: the main path on {bad} launched "
                             f"other than rr_depth closest-hit and one "
                             f"any-hit launch a batch through the kernels")
    return per_batch


def _counters():
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.ops import gather
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc

    launches = {"k1_closest_hit": tc.closest_hit,
                "k2_any_hit": ta.any_hit,
                "k3_closest_hit_stream": tc.closest_hit_stream,
                "k4_any_hit_stream": ta.any_hit_stream,
                "k5_closest_hit_full": tc.closest_hit_full,
                "k6_closest_hit_sweep": tc.closest_hit_sweep,
                "k7_any_hit_compact": ta.any_hit_compact,
                "g1_gather_rows_backward": gather.gather_rows_backward}
    # R1's launches are read by phase_rng alone.
    plains = (tc.closest_hit_plain, ta.any_hit_plain,
              tc.closest_hit_stream_plain, ta.any_hit_stream_plain,
              tc.closest_hit_full_plain, tc.closest_hit_sweep_plain,
              ta.any_hit_compact_plain, gather.gather_rows_backward_plain,
              rng.fold_in_plain, rng.uniform1_plain, rng.uniform2_plain)
    return launches, plains


def reset_counts():
    launches, plains = _counters()
    for fn in launches.values():
        fn.launches = 0
    for fn in plains:
        fn.cuda_calls = 0


def read_counts():
    """(launches by kernel, calls of plain versions on CUDA tensors)."""
    launches, plains = _counters()
    return ({k: fn.launches for k, fn in launches.items()},
            sum(fn.cuda_calls for fn in plains))


# G1 on one config #5 descent step's calls (phase gather).  Each lane's
# gradient reaches its row's sum through at most about 60 float32
# additions at 3M lanes (the warp's tree, the warp's row, the block's
# warps, the blocks, the final butterfly): under 60 x 2^-24 < 4e-6 of the
# row's sum of |g| off a float64 sum, the tight hold.  The plain version
# adds a row's 1,048,576 lanes one at a time with atomics, in any order:
# it read 9.9e-4 of that sum off G1 (and so off float64) on an H100, so
# the hold to it is 1e-2.
GATHER = dict(res=1024, tol_exact=4e-6, tol_plain=1e-2)


def phase_gather(device, smi):
    """G1 (csrc/gather_backward.cu through ops/gather.py) on the calls of
    one config #5 descent step (probes/gather_backward.py: 1024x1024, 2
    spp, rr_depth 2).  The step runs with the launch counts reset just
    before: K1, K2 and G1 (two launches a call with lanes, one without)
    and no other kernel, no plain version on CUDA tensors.  Its calls
    are replayed with the counts reset again, G1 alone launching, and
    each call's sums held to a float64 sum and to the plain version
    (index_add_) and bit-identical on a second call; device ms over the
    step's calls of G1, of the plain version and of autograd's default
    backward of `table[ids]` (index_put_ with accumulate), beside the
    bound of the bytes they read."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "probes"))
    import gather_backward as probe

    from bpt_tpu_torch.ops import gather

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    calls = probe.step_calls(GATHER["res"], device)
    torch.cuda.synchronize()
    step, step_plain_calls = read_counts()
    reset_counts()
    got = [gather.gather_rows_backward(*c) for c in calls]
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    again = [gather.gather_rows_backward(*c) for c in calls]
    identical = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for x, y in zip(got, again) for a, b in zip(x, y))
    # The largest |difference| over a row's sum of |g|: G1 against float64,
    # G1 against the plain version, the plain version against float64.
    errs = {"exact": 0.0, "plain": 0.0, "plain_exact": 0.0}
    max_abs = 0.0
    for (ids, grads, m), sums in zip(calls, got):
        plain = gather.gather_rows_backward_plain(ids.long(), grads, m)
        for g, k, p in zip(grads, sums, plain):
            exact = torch.zeros((m, g.shape[1]), dtype=torch.float64,
                                device=device).index_add_(0, ids.long(),
                                                          g.double())
            scale = torch.zeros_like(exact).index_add_(0, ids.long(),
                                                       g.double().abs())
            max_abs = max(max_abs, float((k - p).abs().max()))
            for name, d in (("exact", k.double() - exact),
                            ("plain", k.double() - p.double()),
                            ("plain_exact", p.double() - exact)):
                d = d.abs()
                errs[name] = max(errs[name], float(
                    torch.where(scale > 0, d / scale, d).max()))
    timing = probe.compare(calls)
    out = {"phase": "gather", "config": f"config #5 step {GATHER['res']}x"
           f"{GATHER['res']} spp 2 rr2", "nvidia_smi": smi,
           "calls": len(calls), "step_launches": step,
           "step_plain_calls_on_cuda": step_plain_calls,
           "launches": launches, "plain_calls_on_cuda": plain_calls,
           "lanes_per_call": [c[0].numel() for c in calls],
           "tables_per_call": [len(c[1]) for c in calls],
           "bit_identical": identical,
           "max_rel_err_vs_float64": errs["exact"],
           "max_rel_err_vs_plain": errs["plain"],
           "plain_max_rel_err_vs_float64": errs["plain_exact"],
           "max_abs_err": max_abs,
           **timing}
    emit(out, t0)
    g1 = sum(2 if c[0].numel() else 1 for c in calls)
    if (plain_calls or step_plain_calls or not identical
            or step["g1_gather_rows_backward"] != g1
            or launches["g1_gather_rows_backward"] != g1
            or min(step["k1_closest_hit"], step["k2_any_hit"]) <= 0
            or any(n for k, n in step.items() if k not in (
                "k1_closest_hit", "k2_any_hit", "g1_gather_rows_backward"))
            or any(n for k, n in launches.items()
                   if k != "g1_gather_rows_backward")
            or errs["exact"] > GATHER["tol_exact"]
            or errs["plain"] > GATHER["tol_plain"]):
        raise AssertionError(f"gather: G1 failed its checks {out}")
    del calls, got, again
    torch.cuda.empty_cache()
    return {"launches_per_step": step["g1_gather_rows_backward"],
            "max_abs_err": max_abs, "ms": timing["kernel_ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "library_ms": timing["library_ms"]}


# The threefry kernel R1 (phase rng): lanes a timed call, and the bytes a
# lane moves in each call (its key read, its data read, its output written).
# Timed calls cycle through copies of their inputs of at least cold_bytes
# in all, twice the L2 cache, so each call reads its inputs from memory.
RNG = dict(lanes=(131_072, 1_048_576), reps=20, cold_bytes=100e6,
           bytes_per_lane={"fold_in": 32, "fold_in_ids": 36,
                           "uniform1": 20, "uniform2": 24})


def device_us(fn, reps):
    """(device us a call, device kernels a call, host wall us a call, mean
    us a kernel) of `reps` calls of fn() after one warm-up call: the
    profiler's kernel durations, and the host clock around the calls and
    one sync.  The profiler may miss a kernel at its start, so a call of
    one kernel is timed by the mean kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    work = [ev.duration_ns() for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CUDA
            and not ev.is_user_annotation()]
    return (sum(work) / 1e3 / reps, len(work) / reps, 1e6 * wall / reps,
            sum(work) / 1e3 / max(len(work), 1))


def phase_rng(device, smi):
    """R1 (csrc/threefry.cu through ops/threefry.py): each call of the
    three RNG functions one launch, bit-equal to its plain version on the
    card, device us a call on RNG['lanes'] lanes (inputs not in L2) beside
    the plain version's and the bound of the bytes it moves."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.ops import threefry

    t0 = time.perf_counter()
    calls = {
        "fold_in": (lambda k, ids: rng.fold_in(k, rng.BSDF_SAMPLE),
                    lambda k, ids: rng.fold_in_plain(k, rng.BSDF_SAMPLE)),
        "fold_in_ids": (lambda k, ids: rng.fold_in(k, ids),
                        lambda k, ids: rng.fold_in_plain(k, ids)),
        "uniform1": (lambda k, ids: rng.uniform1(k),
                     lambda k, ids: rng.uniform1_plain(k)),
        "uniform2": (lambda k, ids: rng.uniform2(k),
                     lambda k, ids: rng.uniform2_plain(k)),
    }
    equal, per_call, us, plain_us, bound_us = True, {}, {}, {}, {}
    host_us, plain_host_us, kernels, plain_kernels = {}, {}, {}, {}
    for n in RNG["lanes"]:
        ids = torch.arange(n, device=device, dtype=torch.int32)
        keys = rng.lane_keys(rng.key(SEED, device), ids)
        copies = itertools.cycle([(keys.clone(), ids.clone()) for _ in range(
            int(-(-RNG["cold_bytes"] // (20 * n))))])
        for name, (kernel, plain) in calls.items():
            before = threefry.threefry_cuda.launches
            got = kernel(keys, ids)
            per_call[name] = threefry.threefry_cuda.launches - before
            want = plain(keys, ids)
            if got.dtype == torch.float32:
                got, want = got.view(torch.int32), want.view(torch.int32)
            equal = equal and got.shape == want.shape and bool(
                torch.equal(got, want))
            at = f"{name}.{n}"
            _, kernels[at], host_us[at], us[at] = device_us(
                lambda: kernel(*next(copies)), RNG["reps"])
            plain_us[at], plain_kernels[at], plain_host_us[at], _ = \
                device_us(lambda: plain(*next(copies)), RNG["reps"])
            bound_us[at] = 1e6 * n * RNG["bytes_per_lane"][name] / PEAK_BYTES
    out = {"phase": "rng", "nvidia_smi": smi, "launches_per_call": per_call,
           "bit_equal": equal, "us_per_call": us, "plain_us_per_call":
           plain_us, "bound_us": bound_us, "kernels_per_call": kernels,
           "plain_kernels_per_call": plain_kernels,
           "host_us_per_call": host_us, "plain_host_us_per_call":
           plain_host_us,
           "share_of_bound": {k: bound_us[k] / us[k] for k in us}}
    emit(out, t0)
    if (not equal or set(per_call.values()) != {1}
            or not all(0.9 <= k <= 1 for k in kernels.values())):
        raise AssertionError(f"rng: R1 failed its checks {out}")
    big = RNG["lanes"][-1]
    return {"launches_per_call": per_call,
            "ms": {k: us[f"{k}.{big}"] / 1e3 for k in calls},
            "plain_ms": {k: plain_us[f"{k}.{big}"] / 1e3 for k in calls},
            "bound_ms": {k: bound_us[f"{k}.{big}"] / 1e3 for k in calls}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import bpt_tpu_torch  # noqa: F401  (sets the TF32 switches)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return _phases(device, phase_device())


def _phases(device, info):
    from bpt_tpu_torch.ops import trace_closest as tc

    smi = info["nvidia_smi"]
    scene, _, cam = bench_scene(device)
    r1 = phase_rng(device, smi)
    scene6 = phase_subdiv6(device)
    l = BENCH["rr_depth"] - 1
    n_connect = l * (l + 2) * BENCH["width"] * BENCH["height"] * BENCH["sb"]
    bench_rays = compacted_k1_inputs(scene, cam, device)
    bench_segs = k2_inputs(scene, device, n_connect)
    rays6 = compacted_k1_inputs(scene6, cam, device)
    segs6 = k2_inputs(scene6, device, n_connect)
    k1 = phase_k1((("bench", scene.treelets, bench_rays),
                   ("subdiv6", scene6.treelets, rays6)), info)
    k2 = phase_k2((("bench", scene.treelets_any, bench_segs),
                   ("subdiv6", scene6.treelets_any, segs6)), info)
    phase_k12_edges(scene, device)
    rays6, segs6 = rays6[0], segs6[1]
    large, _, cfg_t = phase_large_scene(device)
    large_rays = compacted_k1_inputs(large, cfg_t.camera, device)
    large_segs = k2_inputs(large, device, n_connect)
    k3 = phase_k3(large, large_rays, scene, bench_rays, info)
    k4 = phase_k4(large, large_segs, scene, bench_segs, info)
    del large_rays, large_segs
    per_batch = phase_launches(device, (
        ("bench", scene, cam, ("k1_closest_hit", "k2_any_hit")),
        ("large", large, cfg_t.camera,
         ("k3_closest_hit_stream", "k4_any_hit_stream"))))
    del large
    closest_tables = (("bench", scene.treelets, bench_rays[0]),
                      ("subdiv6", scene6.treelets, rays6))
    k5 = phase_closest_kernel(
        "k5_closest_hit_full", tc.closest_hit_full, tc.closest_hit_full_plain,
        closest_tables, exact_vs_k1=True,
        ptxas=kernel_resources(info, "closest_hit_full_kernel",
                               FULL_REGISTER_BUDGET))
    k6 = phase_closest_kernel(
        "k6_closest_hit_sweep", tc.closest_hit_sweep,
        tc.closest_hit_sweep_plain, closest_tables, exact_vs_k1=False,
        ptxas=kernel_resources(info, "closest_hit_sweep_kernel",
                               TILE_REGISTER_BUDGET))
    del rays6, closest_tables
    k7 = phase_k7((("bench", scene.treelets_any, bench_segs[1]),
                   ("subdiv6", scene6.treelets_any, segs6)), info)
    del bench_rays, bench_segs, segs6, scene6
    torch.cuda.empty_cache()
    g1 = phase_gather(device, smi)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(nvidia_smi_line(), flush=True)
    kernels = [
        ("closest_hit", "closest_hit.cu", "bpt_tpu/ops/pallas_trace.py:296",
         "bench", "k1_closest_hit", k1),
        ("any_hit", "any_hit.cu", "bpt_tpu/ops/pallas_sweep.py:216",
         "bench", "k2_any_hit", k2),
        ("closest_hit_stream", "closest_hit_stream.cu",
         "bpt_tpu/ops/pallas_sweep.py:289", "large", "k3_closest_hit_stream",
         k3),
        ("any_hit_stream", "any_hit_stream.cu",
         "bpt_tpu/ops/pallas_sweep.py:235", "large", "k4_any_hit_stream",
         k4),
        ("closest_hit_full", "closest_hit_full.cu",
         "bpt_tpu/ops/pallas_trace.py:71", "bench", "k5_closest_hit_full",
         k5),
        ("closest_hit_sweep", "closest_hit_sweep.cu",
         "bpt_tpu/ops/pallas_sweep.py:263", "bench", "k6_closest_hit_sweep",
         k6),
        ("any_hit_compact", "any_hit_compact.cu",
         "bpt_tpu/ops/pallas_trace.py:559", "bench", "k7_any_hit_compact",
         k7),
    ]
    rows = []
    for name, src, replaces, path, count, res in kernels:
        # No single PyTorch call computes a closest hit or an occlusion
        # test over a treelet table, so there is no library time.  The
        # launches are a main-path batch's (phase launches) on the scene
        # that routes to the kernel, or on the bench scene for K5-K7,
        # which no route takes.
        row = {"name": name, "route": "cuda",
               "source": "bpt_tpu_torch/csrc/" + src, "replaces": replaces,
               "launches_per_batch": per_batch[path][count],
               "max_abs_err": res["max_abs_err"],
               "ms": res["ms"], "plain_ms": res["plain_ms"],
               "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
               "library_ms": None}
        if "flag_mismatch" in res:
            row["flag_mismatch"] = res["flag_mismatch"]
        rows.append(row)
    # G1 replaces no TPU kernel; its library yardstick is autograd's own
    # backward of `table[ids]`.  Its times are over one config #5 step's
    # calls, which launch it twice a call; its launches are the step's.
    rows.append({"name": "gather_rows_backward", "route": "cuda",
                 "source": "bpt_tpu_torch/csrc/gather_backward.cu",
                 "replaces": None,
                 "launches_per_step": g1["launches_per_step"],
                 "max_abs_err": g1["max_abs_err"], "ms": g1["ms"],
                 "plain_ms": g1["plain_ms"], "bound_ms": g1["bound_ms"],
                 "bound_by": "bytes", "library_ms": g1["library_ms"]})
    # R1 replaces no TPU kernel: XLA fused jax.random's threefry.  Its
    # times are a call of each RNG function on RNG['lanes'][-1] lanes; its
    # launches a main-path batch on the bench scene (phase launches).
    rows.append({"name": "threefry", "route": "cuda",
                 "source": "bpt_tpu_torch/csrc/threefry.cu",
                 "replaces": None,
                 "launches_per_batch": per_batch["bench"]["threefry"],
                 "launches_per_call": r1["launches_per_call"],
                 "max_abs_err": 0.0, "ms": r1["ms"],
                 "plain_ms": r1["plain_ms"], "bound_ms": r1["bound_ms"],
                 "bound_by": "bytes", "library_ms": None})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
