"""Bring-up check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from bpt_tpu_torch/csrc/, the seven trace
kernels, G1 (the gathers' backward) and R1 (threefry, the RNG), and checks
each one against its plain PyTorch version at the main paths' shapes.
First `rng`: each of fold_in, uniform1 and uniform2 one R1 launch,
bit-equal to its plain version, timed on 131,072 and 1,048,576 lanes
beside its byte bound, and a bench chunk's R1 launches a sample, held to
the chunk with the three functions swapped for their plain versions.
Then the trace kernels:
K1-K4 as the routes of `accel/api.py` use them (K3 and K4 also against
K1's and K2's plain versions, whose functions they compute), and K1, K2,
K5 (full-table closest hit), K6 (tile-sweep closest hit) and K7
(tile-union any hit) on the bench scene (19 treelets) and on the glass
box with a subdiv-6 sphere (923 treelets), where K5 also holds to K1,
K6's t to K1's and K7 to K2.  K1, K2, K6 and K7 also run edge inputs:
one ray, a ragged batch, all lanes dead, a table of one treelet and one
of 2,048 with a full and many empty treelets.  Every timed kernel call is printed
beside its bound (`trace_bound`: the FP32 operations and bytes that its
inputs need, over the card's peak rates) and its share of that bound.
Four paths are driven through `render_chunk` (256x256, rr_depth 8, 2
samples per batch, seed 7, 16 spp):

  * the bench configuration: the procedural glass Cornell box (19
    treelets), traced by K1 (closest hit) and K2 (any hit), and held to
    the same render through their plain versions;
  * the same with K5 and K7 in place of K1 and K2, and with K6 in place
    of K1 (the routes swapped with mock.patch), each held to the K1/K2
    render;
  * the large scene: the glass box with a subdiv-7 sphere (327,704
    triangles, 3,656 treelets) written as a scene file (TOML + OBJ/MTL)
    and read back through `load_toml` and `load_scene`, traced by the
    streamed kernels K3 and K4.

Three more paths run K1 and K2:

  * `slice_sb4`: the bench configuration at 4 samples a batch, whose
    pair grid (49 x 262,144 lanes) goes through the chunked connect, held
    to the 2-samples-a-batch render;
  * `slice_rr`: BASELINE config #4's settings (512x512, Russian roulette
    from depth 2, 12 bounces, one sample a batch: 13 K1 and 7 K2 launches
    a sample) on the glass box written as a scene file, held to the same
    samples through the plain versions;
  * `modes`: BDPT, the path tracer and the light tracer on the
    all-diffuse box over 6 seeds, their image means held to |z| < 4 where
    they estimate the same image (with Russian roulette, and without it
    on 15-step walks), and light_trace / path_trace renders of the glass
    box held to renders through the plain versions.

The other integrators and the command-line renderer run K1-K4 too:

  * `path`: the explicit path tracer with the scene file's defaults
    (Russian roulette from depth 5, 32 bounces, one emitter sample) on
    the bench scene, 256x256, 4 spp, through K1; rays/s, K1 launches a
    sample (at most 1 + 32 x 9 = 289; fewer where a loop ends early),
    peak memory, device busy time and idle share; `path_large`: the same
    on the large scene read from its file, 1 spp, through K3;
  * `direct`: the five strategies of integrators/direct.py, and `misc`:
    normal, simple, ao and ro, on the bench scene at 256x256, 4 spp
    (ao also on the large scene through K3/K4), with their launches a
    sample asserted;
  * each of these held to its render through the plain versions at
    64x64 (32x32 on the large scene), with compare_paths' gate;
  * `integrators_xest`: the path tracer against BDPT with roulette on
    modes' all-diffuse box and seeds (64x64, 8 spp, 16 bounces), |z| < 4;
  * `cli`: `python -m bpt_tpu_torch.cli` in a subprocess on 512x512
    scene files: bdpt with --checkpoint and then resumed, path, direct
    (mis) and ao, each EXR read back and its meta.json naming the card.

Differentiation and the realtime loop run them as well:

  * `grad`: tests/test_grad.py's checks on the glass box at 64x64 (4
    spp, rr_depth 3, chunks of 2) through K1/K2: every material field's
    gradient finite in bdpt, path_trace, light_trace and Russian-roulette
    mode and held to the gradient through the plain versions (of the
    trace kernels and of G1) within 1e-4 of its norm, autograd against
    central finite differences (eps 1e-2) on diffuse[0,0] and
    emission[5,1]; the forward and backward walls
    and peak memory of a bench chunk (256x256, rr8, 2 samples in one
    batch); `grad_large`: the same hold to the plain versions on the
    large scene (64x64, 1 spp) through K3/K4;
  * `inverse`: BASELINE config #5 (probes/inverse_recover.py: 1024x1024,
    spp 2, rr_depth 2) for 10 iterations of recover_materials: losses,
    step time, peak memory and one profiled step; the loss must fall and
    every gradient be finite;
  * `gather`: G1 on the calls of one config #5 descent step, held to a
    float64 sum and to its plain version (index_add_), bit-identical from
    call to call, and timed beside its plain version, autograd's default
    backward of `table[ids]` (index_put_ with accumulate) and the bound
    of the bytes it reads;
  * `realtime`: realtime.py's run_realtime for the normal, simple, ssao
    and gi passes at 256x256 (ms a frame, frames/s, launches a frame),
    simple held to its frames through the plain versions (0 pixels off),
    run_interactive with a fly script, and one `python -m
    bpt_tpu_torch.cli` process on a realtime = true scene file.

Pooled light transport, the device mesh and the native BVH builder run
them too; the mesh is a world of one rank over NCCL (the card is one
GPU):

  * `pool`: the bench configuration with a pool of 64 light subpaths, 2
    spp, through parallel/mesh.py's render_chunk_pool_ring (15 K1 and 39
    K2 launches a sample: 25 connect chunks), held to the single-device
    render_sample_pool loop; connect_pool on one sample at the default
    chunk budget and at chunks of 6 and 1 pool vertices (1: the
    reference's lane budget at this width); at 64x64 through the kernels
    against their plain versions; `pool_xest`: pooled against per-pixel
    BDPT means over 6 seeds at 64x64, gated (|z| < 4) at a pool of W*H
    paths;
  * `pool_large`: the pool (64x64, 16 paths) on the large scene through
    K3/K4, held to their plain versions;
  * `sharded`: render_image_sharded on the bench configuration at 4 spp,
    both framebuffer merges, against render_image, and their walls;
  * `native`: the large scene loaded with the native and with the numpy
    BVH builder: load and build times, trees and scenes equal.

Each kernel's launch count is reset just before each path runs and read
just after; the kernels line sums them over the paths.  A small render
through the kernels is compared with one through the plain versions on
each scene.  One JSON line per phase, each
with its `elapsed_s`; the second-to-last lines are the card's
`nvidia-smi` name and power limit and the per-kernel summary; the last
line is {"ok": true, "device": {...}}.  Any failed check raises, so the
exit code is not 0 and no result line is printed.  Without a CUDA device
it exits with code 2.  JAX is never imported.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

SEED = 7
BENCH = dict(width=256, height=256, spp=16, rr_depth=8, sb=2)
SMALL = dict(width=64, height=64, spp=4, rr_depth=5)
LARGE = dict(sphere_subdiv=7, n_triangles=327_704, n_treelets=3_656)
SMALL_LARGE = dict(width=32, height=32, spp=2, rr_depth=4)
# BASELINE config #4's settings (benchmarks/hardlight_512.py:54-55), the
# first of the Russian-roulette path; 2 samples of one a batch.
RR = dict(width=512, spp=2, rr_depth=2, max_bounces=12)
# The cross-estimator check (tests/test_bdpt.py) on the card; deep_rr_depth:
# the walks' depth without roulette at which truncation no longer shows.
MODES = dict(width=64, spp=8, rr_depth=3, replicates=6, max_bounces=16,
             deep_rr_depth=16)
# The other integrators (path.py, direct.py, misc.py) at the bench's
# width, and their renders through the plain versions at 64x64.
OTHER = dict(width=256, spp=4, plain_width=64, plain_spp=2)
# Closest-hit launches a sample of the explicit path tracer with the scene
# file's defaults if none of its loops ended early: the primary rays, then
# at each of 32 bounces the emitter sample and 8 re-rolls.
PATH_K1_MAX = 1 + 32 * (1 + 8)
# Samples of the path tracer on the large scene (phase path_large).
PATH_LARGE_SPP = 1
# The path tracer against BDPT (phase integrators_xest), both with Russian
# roulette to 16 bounces, on modes' box and seeds.
XEST = dict(width=64, spp=8, replicates=6, max_bounces=16, bdpt_rr_depth=3,
            path_rr_depth=5)
# The command-line renderer on scene files: 512x512, bdpt at 4 spp in
# chunks of 2 (checkpointed), the others at 4 spp.
CLI = dict(width=512, bdpt_spp=4, spp=4, timeout_s=300)
# Pooled light transport (phase pool): the bench configuration with a pool
# of 64 light subpaths, 2 spp, through render_chunk_pool_ring at world
# size 1; connect chunks of the default budget and of `chunks` pool
# vertices timed on one sample (1 is the reference's TPU budget of
# 458,752 lanes at this width); kernels against plain versions at 64x64;
# pooled against per-pixel BDPT means on modes' all-diffuse box.
POOL = dict(light_pool=64, spp=2, chunks=(6, 1), small_width=64,
            small_spp=2, z_spp=4, z_rr_depth=3, replicates=6)
# The pool on the large scene through K3/K4 (phase pool_large).
POOL_LARGE = dict(width=64, light_pool=16, spp=2)
# render_image_sharded at world size 1 (phase sharded): the bench
# configuration cut to 4 spp.
SHARDED_SPP = 4
# The second table of K5-K7: 29 runs of 32 treelets, whose packed rows
# do not fit in shared memory.
SUBDIV6 = dict(sphere_subdiv=6, n_treelets=923)
# The bench scene's 19 treelets in groups of 8: three groups, the last
# one ragged.
BENCH_CHUNK = 8
DEAD_FRAC_K1 = 0.10
LIVE_FRAC_K2 = 0.30
REPS = 5
# The device kernels outside the trace kernels and sorts that a profile
# names, by their summed time.
PROFILE_TOP = 6
# The large scene's rays per chunk in the K3/K4 render before their
# redesign (the script's run on an H100 at commit be61a0e); the
# redesigned K3 visits treelets in another order, which may change the
# triangle of an exact-t tie and so a path, never t.
LARGE_NRAYS_BEFORE = 18_017_167
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


class _TimedBuilder:
    """A BVH builder that records its wall time and its tree, swapped
    into scene/scene.py for one load."""

    def __init__(self, build):
        self.build, self.s, self.tree = build, 0.0, None

    def __call__(self, v0, v1, v2):
        t = time.perf_counter()
        self.tree = self.build(v0, v1, v2)
        self.s = time.perf_counter() - t
        return self.tree


def phase_large_scene(device, smi):
    """The large scene as a user brings it: written as TOML + OBJ/MTL to a
    temporary directory, then read back through load_toml and load_scene
    (the native BVH builder); phase_native loads it again with the numpy
    builder."""
    from unittest import mock

    from bpt_tpu_torch.accel.build import build_bvh
    from bpt_tpu_torch.scene import scene as scene_mod
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
        builder = _TimedBuilder(build_bvh)
        with mock.patch.object(scene_mod, "build_bvh", builder):
            scene, meta = load_scene(cfg.obj_file, device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        phase_native(cfg.obj_file, device, smi, scene, builder, t2 - t1)
    nt = scene.treelets.block.shape[0]
    out = {"phase": "large_scene", "config": "glass cbox, sphere subdiv 7, "
           "scene file -> load_toml -> load_scene",
           "n_triangles": meta.n_triangles, "n_treelets": nt,
           "n_treelets_any": scene.treelets_any.block.shape[0],
           "obj_bytes": obj_bytes, "write_s": t1 - t0, "load_s": t2 - t1,
           "bvh_build_s": builder.s,
           "toml": {"width": cfg.width, "height": cfg.height,
                    "spp": cfg.spp, "rr_depth": cfg.rr_depth}}
    emit(out, t0)
    if (meta.n_triangles, nt) != (LARGE["n_triangles"], LARGE["n_treelets"]):
        raise AssertionError("the large scene is not the 327,704-triangle, "
                             "3,656-treelet glass box")
    return scene, meta, cfg


def phase_native(obj_file, device, smi, scene, native_builder, native_load_s):
    """The large scene loaded again with the numpy BVH builder in place of
    the native one: both load times and build times, the trees equal
    array for array and the two scenes' tensors equal."""
    from unittest import mock

    from bpt_tpu_torch.accel.build import build_bvh_numpy
    from bpt_tpu_torch.scene import scene as scene_mod
    from bpt_tpu_torch.scene.scene import flatten_fields, load_scene

    t0 = time.perf_counter()
    builder = _TimedBuilder(build_bvh_numpy)
    with mock.patch.object(scene_mod, "build_bvh", builder):
        scene_np, _ = load_scene(obj_file, device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    a, b = native_builder.tree, builder.tree
    trees_equal = all(
        getattr(a, f).shape == getattr(b, f).shape
        and (getattr(a, f) == getattr(b, f)).all()
        for f in ("bmin", "bmax", "miss", "start", "count", "prim_order"))
    fields = dict(flatten_fields(scene_np))
    scenes_equal = all(torch.equal(v, fields[k]) for k, v in
                       flatten_fields(scene) if torch.is_tensor(v))
    out = {"phase": "native", "config": "the large scene's OBJ, "
           "load_scene with each BVH builder", "nvidia_smi": smi,
           "n_nodes": int(a.n_nodes),
           "load_s": {"native": native_load_s, "numpy": load_s},
           "bvh_build_s": {"native": native_builder.s, "numpy": builder.s},
           "build_speedup": builder.s / native_builder.s,
           "trees_equal": trees_equal, "scenes_equal": scenes_equal}
    emit(out, t0)
    if not (trees_equal and scenes_equal):
        raise AssertionError("the native and numpy builders' trees differ")


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


_KERNEL_GROUPS = (("k3_closest_hit_stream", "closest_hit_stream_kernel"),
                  ("k4_any_hit_stream", "any_hit_stream_kernel"),
                  ("k1_closest_hit", "closest_hit_kernel"),
                  ("k2_any_hit", "any_hit_kernel"),
                  ("k5_closest_hit_full", "closest_hit_full_kernel"),
                  ("k6_closest_hit_sweep", "closest_hit_sweep_kernel"),
                  ("k7_any_hit_compact", "any_hit_compact_kernel"))


def _profile_batch(scene, cam_consts, cfg, key, batch_wall_s,
                   sb=BENCH["sb"]):
    """_profile_run over one BDPT batch of `sb` samples."""
    from bpt_tpu_torch.integrators.bdpt import render_chunk

    return _profile_run(lambda: render_chunk(scene, cam_consts, cfg, key, sb,
                                             samples_per_batch=sb),
                        batch_wall_s)


def _profile_run(run, batch_wall_s):
    """Device time by kernel over one call of `run`, one batch of a render
    (torch.profiler).  The idle share is taken against `batch_wall_s`,
    the unprofiled wall of one batch, because the profiler itself slows
    the host down; the share against the profiled batch's wall is
    printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    # Device activity only: the busy time is read from kernel events
    # alone; the profiler's own work after the batch is printed as
    # `profile_processing_s`.
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {g: 0.0 for g, _ in _KERNEL_GROUPS}
    groups.update(sort=0.0, other=0.0)
    others = {}
    # The raw device events (kernels, copies, fills), not key_averages(),
    # which first builds a Python object for every event of the run: 38-46
    # s for one path tracer sample on an H100.
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name()
        group = next((g for g, k in _KERNEL_GROUPS if k in name), None)
        if group is None:
            low = name.lower()
            group = "sort" if "sort" in low or "radix" in low else "other"
        groups[group] += ev.duration_ns() / 1e3
        if group == "other":
            others[name] = others.get(name, 0.0) + ev.duration_ns() / 1e9
    processing_s = time.perf_counter() - t_all - wall
    total = sum(groups.values())
    if total == 0.0:
        return {"profile": "not measured (no device time in the trace)"}
    busy = total / 1e6
    return {"device_busy_s": busy, "batch_wall_s": batch_wall_s,
            "device_idle_share": max(0.0, 1.0 - busy / batch_wall_s),
            "profile_wall_s": wall,
            "device_idle_share_profiled": max(0.0, 1.0 - busy / wall),
            "profile_processing_s": processing_s,
            "device_s_by_group": {k: v / 1e6 for k, v in groups.items()},
            "top_other_s": dict(sorted(others.items(), key=lambda kv: -kv[1])
                                [:PROFILE_TOP])}


def _identity_layout(o, d, min_t, max_t, bounds=None, kind="segment"):
    """compact_rays' interface with the lanes left where they are."""
    from bpt_tpu_torch.ops.compaction import CompactPlan

    b = o.shape[0]
    mn = torch.as_tensor(min_t, dtype=torch.float32,
                         device=o.device).expand(b).contiguous()
    mx = torch.as_tensor(max_t, dtype=torch.float32,
                         device=o.device).expand(b).contiguous()
    return o, d, mn, mx, CompactPlan(torch.arange(b, device=o.device),
                                     mx >= mn)


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
    # R1's launches are read by phase_rng alone: every path launches it.
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


def phase_slice(scene, cam, device, smi):
    """The bench configuration through K1 and K2."""
    from unittest import mock

    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc

    t0 = time.perf_counter()
    cfg = BDPTConfig(BENCH["width"], BENCH["height"], spp=BENCH["spp"],
                     rr_depth=BENCH["rr_depth"])
    cam_consts = cam.device_constants(device)
    key = rng.key(SEED, device)

    def chunk():
        fb, nr = render_chunk(scene, cam_consts, cfg, key, cfg.spp,
                              samples_per_batch=BENCH["sb"])
        torch.cuda.synchronize()
        return fb, int(nr)

    tw = time.perf_counter()
    chunk()
    warm_s = time.perf_counter() - tw

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tw = time.perf_counter()
    fb, nrays = chunk()
    wall = time.perf_counter() - tw
    launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()

    # Spread, and compaction's share: more chunks, alternating with chunks
    # where compaction is swapped for the identity layout (a measurement
    # harness; results are unchanged because dead lanes miss in the
    # kernels either way).
    walls, walls_nc = [wall], []
    for swapped in (True, False):
        tw = time.perf_counter()
        if swapped:
            with mock.patch.object(api, "compact_rays", _identity_layout):
                fb_nc, nrays_nc = chunk()
            walls_nc.append(time.perf_counter() - tw)
        else:
            chunk()
            walls.append(time.perf_counter() - tw)
    wall_med = statistics.median(walls)

    # The same chunk through the plain versions of K1 and K2, swapped in
    # for this comparison only.
    tw = time.perf_counter()
    with mock.patch.multiple(api, closest_hit=tc.closest_hit_plain,
                             any_hit=ta.any_hit_plain):
        fb_p, nrays_p = chunk()
    vs_plain = {**image_agreement(fb, nrays, fb_p, nrays_p),
                "plain_chunk_s": time.perf_counter() - tw}
    del fb_p

    out = {"phase": "slice", "config": "procedural glass cbox 256x256 "
           "16spp rr8 sb2 seed7", "nvidia_smi": smi, "warmup_s": warm_s,
           "wall_s": wall_med, "wall_s_runs": walls, "nrays": nrays,
           "rays_per_s": nrays / wall_med,
           "peak_mem_bytes": peak, "launches": launches,
           "plain_calls_on_cuda": plain_calls,
           "image_mean": float(fb.mean()),
           "finite": bool(torch.isfinite(fb).all()),
           "wall_s_without_compaction": statistics.median(walls_nc),
           "wall_s_without_compaction_runs": walls_nc,
           "nrays_without_compaction": nrays_nc,
           "image_mean_without_compaction": float(fb_nc.mean()),
           "vs_plain_versions": vs_plain}
    batches = cfg.spp // BENCH["sb"]
    out.update(_profile_batch(scene, cam_consts, cfg, key,
                              wall_med / batches))
    emit(out, t0)
    check_render(out, used=("k1_closest_hit", "k2_any_hit"))
    # Per batch: the primary trace and seven walk depths through K1, the
    # one connect any-hit through K2.
    if (launches["k1_closest_hit"], launches["k2_any_hit"]) \
            != (8 * batches, batches):
        raise AssertionError(f"slice launched {launches} in {batches} "
                             f"batches")
    if not agrees(vs_plain):
        raise AssertionError(f"the K1/K2 render and the render through "
                             f"their plain versions disagree: {vs_plain}")
    return launches, fb, out


def phase_slice_routed(phase, scene, cam, device, smi, routes, counts, base,
                       exact):
    """The bench configuration with `routes` swapped into accel/api.py
    (mock.patch in this script; the package has no switch), held to the
    K1/K2 slice `base` = (its image, its phase line).  `counts` maps each
    kernel of this path to the kernel of the K1/K2 slice whose launch
    count it must equal.  With `exact` (the same function as the K1/K2
    slice) no pixel may be off by more than 1e-3 relative and nrays must
    be equal; otherwise compare_paths' aggregate gate holds."""
    from unittest import mock

    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk

    t0 = time.perf_counter()
    cfg = BDPTConfig(BENCH["width"], BENCH["height"], spp=BENCH["spp"],
                     rr_depth=BENCH["rr_depth"])
    cam_consts = cam.device_constants(device)
    key = rng.key(SEED, device)

    def chunk():
        fb, nr = render_chunk(scene, cam_consts, cfg, key, cfg.spp,
                              samples_per_batch=BENCH["sb"])
        torch.cuda.synchronize()
        return fb, int(nr)

    with mock.patch.multiple(api, **routes):
        tw = time.perf_counter()
        chunk()
        warm_s = time.perf_counter() - tw
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        tw = time.perf_counter()
        fb, nrays = chunk()
        wall = time.perf_counter() - tw
        launches, plain_calls = read_counts()
        peak = torch.cuda.max_memory_allocated()
        prof = _profile_batch(scene, cam_consts, cfg, key,
                              wall / (cfg.spp // BENCH["sb"]))
    base_fb, base_out = base
    v = image_agreement(fb, nrays, base_fb, base_out["nrays"])
    out = {"phase": phase, "config": base_out["config"],
           "routes": {k: v.__name__ for k, v in routes.items()},
           "nvidia_smi": smi, "warmup_s": warm_s, "wall_s": wall,
           "nrays": nrays, "rays_per_s": nrays / wall, "peak_mem_bytes": peak,
           "launches": launches, "plain_calls_on_cuda": plain_calls,
           "image_mean": float(fb.mean()),
           "finite": bool(torch.isfinite(fb).all()),
           "vs_k1_k2_slice": {**v, "wall_s": base_out["wall_s"],
                              "rays_per_s": base_out["rays_per_s"],
                              "peak_mem_bytes": base_out["peak_mem_bytes"]},
           **prof}
    emit(out, t0)
    check_render(out, used=tuple(counts))
    if any(launches[k] != base_out["launches"][b] for k, b in counts.items()):
        raise AssertionError(f"{phase} launched {launches}, the K1/K2 "
                             f"slice {base_out['launches']}")
    if not (v["pixels_off_frac"] == 0.0 and v["nrays_rel"] == 0.0 if exact
            else agrees(v)):
        raise AssertionError(f"{phase} disagrees with the K1/K2 slice: {v}")
    return launches


def phase_slice_large(scene, cfg_t, device, smi):
    """The large scene, read from its scene file, through K3 and K4 at
    the settings of its TOML (256x256, 16 spp, rr8) and 2 samples per
    batch."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk

    t0 = time.perf_counter()
    cfg = BDPTConfig(cfg_t.width, cfg_t.height, spp=cfg_t.spp,
                     rr_depth=cfg_t.rr_depth)
    cam_consts = cfg_t.camera.device_constants(device)
    key = rng.key(SEED, device)

    def chunk():
        fb, nr = render_chunk(scene, cam_consts, cfg, key, cfg.spp,
                              samples_per_batch=BENCH["sb"])
        torch.cuda.synchronize()
        return fb, int(nr)

    tw = time.perf_counter()
    chunk()
    warm_s = time.perf_counter() - tw

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tw = time.perf_counter()
    fb, nrays = chunk()
    wall = time.perf_counter() - tw
    launches, plain_calls = read_counts()
    peak = torch.cuda.max_memory_allocated()

    out = {"phase": "slice_large",
           "config": f"glass cbox subdiv 7 (scene file) {cfg.width}x"
                     f"{cfg.height} {cfg.spp}spp rr{cfg.rr_depth} "
                     f"sb{BENCH['sb']} seed{SEED}",
           "nvidia_smi": smi, "warmup_s": warm_s, "wall_s": wall,
           "nrays": nrays, "rays_per_s": nrays / wall,
           "peak_mem_bytes": peak, "launches": launches,
           "plain_calls_on_cuda": plain_calls,
           "image_mean": float(fb.mean()),
           "finite": bool(torch.isfinite(fb).all()),
           "nrays_before_redesign": LARGE_NRAYS_BEFORE,
           "nrays_rel_vs_before": abs(nrays - LARGE_NRAYS_BEFORE)
           / LARGE_NRAYS_BEFORE}
    batches = cfg.spp // BENCH["sb"]
    out.update(_profile_batch(scene, cam_consts, cfg, key, wall / batches))
    emit(out, t0)
    check_render(out, used=("k3_closest_hit_stream", "k4_any_hit_stream"))
    # Per batch: the primary trace and seven walk depths through K3, the
    # one connect any-hit through K4.
    if (launches["k3_closest_hit_stream"], launches["k4_any_hit_stream"]) \
            != (8 * batches, batches):
        raise AssertionError(f"slice_large launched {launches} in "
                             f"{batches} batches")
    if out["nrays_rel_vs_before"] > 1e-3:
        raise AssertionError(f"slice_large traced {nrays} rays, "
                             f"{LARGE_NRAYS_BEFORE} before the redesign")
    return launches


def check_render(out, used):
    """Finite, not black, every kernel of `used` launched, no other
    kernel and no plain version on CUDA tensors."""
    launches = out["launches"]
    if not out["finite"]:
        raise AssertionError(f"non-finite pixels in {out['phase']}")
    if min(launches[k] for k in used) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: "
                             f"{launches}")
    if any(n for k, n in launches.items() if k not in used):
        raise AssertionError(f"a kernel of another path was launched: "
                             f"{launches}")
    if out["plain_calls_on_cuda"]:
        raise AssertionError("plain versions ran on CUDA tensors")
    if out["image_mean"] <= 0.0:
        raise AssertionError(f"black image in {out['phase']}")


def image_agreement(a, na, b, nb):
    """The aggregates two renders (image, nrays) are compared on: the
    share of pixels off by more than 1e-3 relative, the relative
    difference of the image means and of the ray counts."""
    a, b = a.double(), b.double()
    denom = torch.clamp_min(b.abs(), 1e-3)
    return {"pixels_off_frac": float(((a - b).abs() / denom > 1e-3)
                                     .double().mean()),
            "mean_rel": abs(float(a.mean()) - float(b.mean()))
            / max(float(b.mean()), 1e-9),
            "nrays": [na, nb], "nrays_rel": abs(na - nb) / max(nb, 1)}


def agrees(v):
    """The aggregate gate of a kernel render against a plain one."""
    return (v["pixels_off_frac"] <= 0.02 and v["mean_rel"] <= 1e-3
            and v["nrays_rel"] <= 1e-3)


def compare_paths(name, scene, cam, cfg, routes):
    """A BDPT render through the kernels and one through the plain
    versions, gated on aggregates (compare_renders)."""
    from bpt_tpu_torch.integrators.bdpt import render_image

    compare_renders(name, f"{cfg.width}x{cfg.height} {cfg.spp}spp "
                          f"rr{cfg.rr_depth}",
                    lambda: render_image(scene, cam, cfg, seed=SEED), routes)


def compare_renders(name, config, render, routes):
    """render() -> (image, nrays) once through the kernels and once
    through the plain versions `routes` (swapped into accel/api.py for
    this comparison only), gated on aggregates."""
    from unittest import mock

    from bpt_tpu_torch.accel import api

    t0 = time.perf_counter()
    a, na = render()
    with mock.patch.multiple(api, **routes):
        b, nb = render()
    out = {"phase": "kernel_vs_plain_render", "case": name, "config": config,
           **image_agreement(a, na, b, nb),
           "finite": bool(torch.isfinite(a).all())}
    emit(out, t0)
    if not (agrees(out) and out["finite"]):
        raise AssertionError(f"kernel path and plain path disagree ({name})")


def phase_paths(device, large, cam_large):
    from bpt_tpu_torch.core.camera import Camera
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    w = SMALL["width"]
    scene, _, cam = cornell_box_scene(w, w, device=device,
                                      right_object="glass_sphere",
                                      sphere_subdiv=3)
    compare_paths("bench scene, K1/K2", scene, cam,
                  BDPTConfig(w, w, spp=SMALL["spp"],
                             rr_depth=SMALL["rr_depth"]),
                  dict(closest_hit=tc.closest_hit_plain,
                       any_hit=ta.any_hit_plain))
    w = SMALL_LARGE["width"]
    cam = Camera.make(cam_large.o, cam_large.at, cam_large.up, cam_large.fov,
                      w, w)
    compare_paths("large scene, K3/K4", large, cam,
                  BDPTConfig(w, w, spp=SMALL_LARGE["spp"],
                             rr_depth=SMALL_LARGE["rr_depth"]),
                  dict(closest_hit_stream=tc.closest_hit_stream_plain,
                       any_hit_stream=ta.any_hit_stream_plain))


def _timed_chunk(scene, cam_consts, cfg, key, spp, sb, routes=None):
    """counted() of one render_chunk of `spp` samples in batches of `sb`,
    through `routes` where given."""
    from contextlib import nullcontext
    from unittest import mock

    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.integrators.bdpt import render_chunk

    with mock.patch.multiple(api, **routes) if routes else nullcontext():
        return counted(lambda: render_chunk(scene, cam_consts, cfg, key, spp,
                                            samples_per_batch=sb))


def counted(render):
    """render() -> (image, nrays) with the kernel launch counts reset just
    before and read just after and the peak memory reset before:
    (image, nrays, wall_s, launches, plain_calls, peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tw = time.perf_counter()
    img, nr = render()
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    launches, plain_calls = read_counts()
    return (img, int(nr), wall, launches, plain_calls,
            torch.cuda.max_memory_allocated())


def add_launches(total, launches):
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def phase_slice_rr(device, smi):
    """BASELINE config #4's settings (benchmarks/hardlight_512.py:54-55):
    512x512, rr_depth 2, Russian roulette, 12 bounces, one sample a batch
    (B = 262,144, L = 12): the 144 x B pair grid goes in chunks of 2 eye
    rows, 6 pair any-hit launches and one NEE + t=1 launch a sample.  The
    reference's scene file is not in the repo, so the glass box stands in,
    written by export_cornell_box and read back through load_toml and
    load_scene."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import MEGA_MAX_LANES, BDPTConfig, \
        render_chunk
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc
    from bpt_tpu_torch.scene.export import export_cornell_box
    from bpt_tpu_torch.scene.scene import load_scene
    from bpt_tpu_torch.scene.toml_config import load_toml

    t0 = time.perf_counter()
    w = RR["width"]
    with tempfile.TemporaryDirectory() as tmp:
        cfg_t = load_toml(export_cornell_box(
            tmp, width=w, height=w, spp=RR["spp"], rr_depth=RR["rr_depth"],
            right_object="glass_sphere", sphere_subdiv=3))
        scene, meta = load_scene(cfg_t.obj_file, device)
    cfg = BDPTConfig(cfg_t.width, cfg_t.height, spp=RR["spp"],
                     rr_depth=cfg_t.rr_depth, no_rr=False,
                     max_bounces=RR["max_bounces"])
    cam_consts = cfg_t.camera.device_constants(device)
    key = rng.key(SEED, device)
    l, b = cfg.n_steps, w * w
    rows = max(1, min(l, MEGA_MAX_LANES // (l * b)))
    n_chunks = -(-l // rows)

    tw = time.perf_counter()
    render_chunk(scene, cam_consts, cfg, key, 1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - tw
    fb, nrays, wall, launches, plain_calls, peak = _timed_chunk(
        scene, cam_consts, cfg, key, cfg.spp, 1)
    prof = _profile_batch(scene, cam_consts, cfg, key, wall / cfg.spp, sb=1)
    tw = time.perf_counter()
    fb_p, nrays_p = _timed_chunk(
        scene, cam_consts, cfg, key, cfg.spp, 1,
        dict(closest_hit=tc.closest_hit_plain, any_hit=ta.any_hit_plain))[:2]
    vs_plain = {**image_agreement(fb, nrays, fb_p, nrays_p),
                "plain_chunk_s": time.perf_counter() - tw}
    del fb_p
    per_sample = {k: n / cfg.spp for k, n in launches.items() if n}
    out = {"phase": "slice_rr",
           "config": f"BASELINE #4 settings: {w}x{w} {cfg.spp}spp rr_depth "
                     f"{cfg.rr_depth} RR max_bounces {cfg.max_bounces} sb1 "
                     f"seed{SEED}; glass cbox (stand-in for the reference's "
                     f"cbox_bdpt.toml) via export_cornell_box -> load_toml "
                     f"-> load_scene",
           "n_triangles": meta.n_triangles,
           "n_treelets": scene.treelets.block.shape[0],
           "lanes": b, "walk_steps": l,
           "pair_lanes": l * l * b, "budget": MEGA_MAX_LANES,
           "rows_per_chunk": rows, "pair_chunks": n_chunks,
           "nvidia_smi": smi, "warmup_s": warm_s, "wall_s": wall,
           "nrays": nrays, "rays_per_s": nrays / wall, "peak_mem_bytes": peak,
           "launches": launches, "launches_per_sample": per_sample,
           "plain_calls_on_cuda": plain_calls,
           "image_mean": float(fb.mean()),
           "finite": bool(torch.isfinite(fb).all()),
           "vs_plain_versions": vs_plain, **prof}
    emit(out, t0)
    check_render(out, used=("k1_closest_hit", "k2_any_hit"))
    if (launches["k1_closest_hit"], launches["k2_any_hit"]) != (
            (l + 1) * cfg.spp, (n_chunks + 1) * cfg.spp):
        raise AssertionError(f"slice_rr launched {launches} in {cfg.spp} "
                             f"samples")
    if not agrees(vs_plain):
        raise AssertionError(f"the RR render through K1/K2 and through "
                             f"their plain versions disagree: {vs_plain}")
    return launches


def phase_slice_sb4(scene, cam, device, smi, base):
    """The bench configuration at 4 samples a batch: B = 262,144 lanes,
    a 49 x B pair grid above the budget, so the pairs go in two chunks
    (4 and 3 eye rows); held to the K1/K2 slice (2 samples a batch, the
    unchunked connect) `base` = (its image, its phase line): the batch
    size does not change the estimate."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import MEGA_MAX_LANES, BDPTConfig

    t0 = time.perf_counter()
    sb = 4
    cfg = BDPTConfig(BENCH["width"], BENCH["height"], spp=BENCH["spp"],
                     rr_depth=BENCH["rr_depth"])
    l, b = cfg.n_steps, sb * cfg.width * cfg.height
    rows = max(1, min(l, MEGA_MAX_LANES // (l * b)))
    n_chunks = -(-l // rows) if l * l * b > MEGA_MAX_LANES else 0
    cam_consts = cam.device_constants(device)
    key = rng.key(SEED, device)
    fb, nrays, wall, launches, plain_calls, peak = _timed_chunk(
        scene, cam_consts, cfg, key, cfg.spp, sb)
    base_fb, base_out = base
    v = image_agreement(fb, nrays, base_fb, base_out["nrays"])
    batches = cfg.spp // sb
    out = {"phase": "slice_sb4",
           "config": f"procedural glass cbox {cfg.width}x{cfg.height} "
                     f"{cfg.spp}spp rr{cfg.rr_depth} sb{sb} seed{SEED}",
           "lanes": b, "pair_lanes": l * l * b, "budget": MEGA_MAX_LANES,
           "rows_per_chunk": rows, "pair_chunks": n_chunks,
           "nvidia_smi": smi, "wall_s": wall, "nrays": nrays,
           "rays_per_s": nrays / wall, "peak_mem_bytes": peak,
           "launches": launches, "plain_calls_on_cuda": plain_calls,
           "image_mean": float(fb.mean()),
           "finite": bool(torch.isfinite(fb).all()),
           "vs_sb2_slice": {**v, "wall_s": base_out["wall_s"],
                            "rays_per_s": base_out["rays_per_s"],
                            "peak_mem_bytes": base_out["peak_mem_bytes"]}}
    emit(out, t0)
    check_render(out, used=("k1_closest_hit", "k2_any_hit"))
    # Per batch: the primary trace and a walk trace a depth through K1;
    # one NEE + t=1 any-hit and one a pair chunk through K2 (2 chunks of
    # 4 and 3 eye rows at 256x256).
    if (launches["k1_closest_hit"], launches["k2_any_hit"]) != (
            (l + 1) * batches, (1 + n_chunks) * batches):
        raise AssertionError(f"slice_sb4 launched {launches} in {batches} "
                             f"batches")
    if not agrees(v):
        raise AssertionError(f"4 samples a batch disagree with 2: {v}")
    return launches


def _pool_render(scene, cc, cfg, key, spp):
    """`spp` samples of render_sample_pool on one device, the whole pool
    in one pass, keyed fold_in(key, s): (fb (W*H, 3), nrays)."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import render_sample_pool

    dev = cc["o"].device
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                       device=dev)
    pids = torch.arange(cfg.light_pool, dtype=torch.int32, device=dev)
    fb = torch.zeros((cfg.width * cfg.height, 3), device=dev)
    nrays = 0
    for s in range(spp):
        fb_s, nr = render_sample_pool(scene, cc, cfg, rng.fold_in(key, s),
                                      pix, pids)
        fb, nrays = fb + fb_s, nrays + int(nr)
    return fb, nrays


def _pool_chunks(scene, cc, cfg, key, chunks):
    """connect_pool on one sample's eye and pool vertices at each chunk
    size (None: the default budget): wall, K2 launches, peak memory and
    how far each sum is from the default's."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.camera import generate_rays
    from bpt_tpu_torch.integrators.bdpt import (
        connect_pool,
        eye_subpath_walk,
        light_subpath_walk,
    )

    n = float(cfg.light_pool)
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                       device=key.device)
    pids = torch.arange(cfg.light_pool, dtype=torch.int32, device=key.device)
    lkeys = rng.lane_keys(key, pix)
    jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    _, d = generate_rays(cc, cfg.width, cfg.height, pix, jitter)
    eye = eye_subpath_walk(scene, cc, cfg, lkeys, d, n_light=n,
                           collect=True)[2]
    pool = light_subpath_walk(
        scene, cc, cfg, rng.lane_keys(rng.stream(key, rng.POOL_WALK), pids),
        cfg.light_pool, torch.ones_like(pids, dtype=torch.bool),
        n_light=n)[0]
    out, base = {}, None
    for chunk in chunks:
        li, nr, wall, launches, _, peak = counted(
            lambda: connect_pool(scene, cfg, eye, pool, cfg.light_pool,
                                 chunk=chunk))
        if base is None:
            base = li
        out["default" if chunk is None else str(chunk)] = {
            "wall_s": wall, "k2_launches": launches["k2_any_hit"],
            "nrays": nr, "peak_mem_bytes": peak,
            "max_rel_diff_vs_default": float(
                (li - base).abs().max() / base.abs().max().clamp_min(1e-30))}
    return out


def phase_pool(scene, cam, device, smi, mesh):
    """Pooled light transport on the bench configuration (256x256,
    rr_depth 8, NO_RR: 7 walk steps) with a pool of POOL["light_pool"]
    subpaths, POOL["spp"] samples, through render_chunk_pool_ring at
    world size 1 over NCCL: per sample one primary, 7 pool-walk and 7
    eye-walk K1 launches, 7 t=1 and 7 NEE K2 launches and one K2 launch
    a connect chunk.  Held to the single-device render_sample_pool loop;
    the chunk budget timed against smaller chunks; at 64x64 the kernels
    against their plain versions and pooled against per-pixel means."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import MEGA_MAX_LANES, BDPTConfig
    from bpt_tpu_torch.parallel.mesh import render_chunk_pool_ring
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    t0 = time.perf_counter()
    spp = POOL["spp"]
    cfg = BDPTConfig(BENCH["width"], BENCH["height"], spp=spp,
                     rr_depth=BENCH["rr_depth"], light_pool=POOL["light_pool"])
    l = cfg.n_steps
    e, lp = l * cfg.width * cfg.height, l * cfg.light_pool
    chunk = max(1, min(lp, MEGA_MAX_LANES // e))
    n_chunks = -(-lp // chunk)
    cc = cam.device_constants(device)
    key = rng.key(SEED, device)
    tw = time.perf_counter()
    _pool_render(scene, cc, cfg, key, 1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - tw
    fb, nrays, wall, launches, plain_calls, peak = counted(
        lambda: render_chunk_pool_ring(scene, cc, cfg, mesh, key, spp))
    fb1, n1, wall1, _, _, _ = counted(
        lambda: _pool_render(scene, cc, cfg, key, spp))
    v = image_agreement(fb, nrays, fb1, n1)
    out = {"phase": "pool", "config": f"procedural glass cbox {cfg.width}x"
           f"{cfg.height} {spp}spp rr{cfg.rr_depth} light_pool "
           f"{cfg.light_pool}, render_chunk_pool_ring 1x1 NCCL, seed{SEED}",
           "nvidia_smi": smi, "warmup_s": warm_s, "wall_s": wall,
           "wall_s_per_sample": wall / spp, "nrays": nrays,
           "rays_per_s": nrays / wall, "peak_mem_bytes": peak,
           "eye_vertices": e, "pool_vertices": lp, "chunk": chunk,
           "connect_chunks_per_sample": n_chunks, "launches": launches,
           "launches_per_sample": {k: n / spp for k, n in launches.items()
                                   if n},
           "plain_calls_on_cuda": plain_calls,
           "image_mean": float(fb.mean()),
           "finite": bool(torch.isfinite(fb).all()),
           "vs_single_device_loop": {**v, "wall_s": wall1},
           "connect_chunks": _pool_chunks(scene, cc, cfg, key,
                                          (None,) + POOL["chunks"])}
    out.update(_profile_run(lambda: _pool_render(scene, cc, cfg, key, 1),
                            wall / spp))
    emit(out, t0)
    check_render(out, used=("k1_closest_hit", "k2_any_hit"))
    if (launches["k1_closest_hit"], launches["k2_any_hit"]) != (
            (1 + 2 * l) * spp, (2 * l + n_chunks) * spp):
        raise AssertionError(f"pool launched {launches} in {spp} samples")
    if not agrees(v):
        raise AssertionError(f"the ring and the single-device pooled "
                             f"render disagree: {v}")

    w = POOL["small_width"]
    small, _, cam_s = cornell_box_scene(w, w, device=device,
                                        right_object="glass_sphere",
                                        sphere_subdiv=3)
    cfg_s = BDPTConfig(w, w, spp=POOL["small_spp"],
                       rr_depth=BENCH["rr_depth"],
                       light_pool=POOL["light_pool"])
    cc_s = cam_s.device_constants(device)
    compare_renders("pool glass box, K1/K2",
                    f"{w}x{w} {cfg_s.spp}spp rr{cfg_s.rr_depth} light_pool "
                    f"{cfg_s.light_pool}",
                    lambda: _pool_render(small, cc_s, cfg_s, key, cfg_s.spp),
                    _plain_routes("k1", "k2"))
    add_launches(launches, phase_pool_xest(device, smi))
    return launches


def phase_pool_xest(device, smi):
    """Pooled against per-pixel BDPT (tests/test_ring.py's consistency
    check on the card): image means over POOL["replicates"] seeds on
    modes' all-diffuse box at 64x64, rr_depth 3.  At a pool of W*H paths
    the MIS weights are the per-pixel ones and the means must agree,
    |z| < 4 (a gap of about 1% reads |z| > 4 here).  The pooled mean
    moves with the pool size (the reference's estimator,
    tests/test_torch_pool_size.py): the bench pool (64 paths) is printed
    with its gap to per-pixel and to the pool of W*H on the same keys,
    not gated."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    t0 = time.perf_counter()
    spp, r, w = POOL["z_spp"], POOL["replicates"], POOL["small_width"]
    scene, _, cam = cornell_box_scene(w, w, device=device)
    cc = cam.device_constants(device)
    base = dict(spp=spp, rr_depth=POOL["z_rr_depth"])
    cfgs = {"per_pixel": BDPTConfig(w, w, **base),
            "pool_of_w_h": BDPTConfig(w, w, light_pool=w * w, **base),
            "bench_pool": BDPTConfig(w, w, light_pool=POOL["light_pool"],
                                  **base)}
    launches, means, walls = {}, {}, {}
    for name, cfg in cfgs.items():
        means[name], walls[name] = [], 0.0
        for i in range(r):
            key = rng.key(100 + i, device)
            if name == "per_pixel":
                run = lambda: render_chunk(scene, cc, cfg, key, spp,
                                           samples_per_batch=spp)
            else:
                run = lambda: _pool_render(scene, cc, cfg, key, spp)
            fb, _, wall, ln, plain_calls, _ = counted(run)
            if plain_calls or not bool(torch.isfinite(fb).all()):
                raise AssertionError(f"{name}: plain calls or non-finite")
            means[name].append(float(fb.double().mean()))
            walls[name] += wall
            add_launches(launches, ln)
    stats = {n: (statistics.mean(m), statistics.stdev(m) / r ** 0.5)
             for n, m in means.items()}
    pp = stats["per_pixel"]
    out = {n: {"light_pool": cfgs[n].light_pool, "mean_and_se": stats[n],
               "z_vs_per_pixel": _z(stats[n], pp),
               "rel_gap_vs_per_pixel": stats[n][0] / pp[0] - 1,
               "wall_s": walls[n]} for n in ("pool_of_w_h", "bench_pool")}
    # The two pools on the same keys: the same eye paths, so the paired
    # differences carry little of the noise.
    d = [a - b for a, b in zip(means["bench_pool"], means["pool_of_w_h"])]
    out["bench_pool_vs_pool_of_w_h_paired"] = {
        "rel_gap": stats["bench_pool"][0] / stats["pool_of_w_h"][0] - 1,
        "z": abs(statistics.mean(d)) / (statistics.stdev(d) / r ** 0.5
                                        + 1e-30)}
    emit({"phase": "pool_xest", "config": f"all-diffuse cbox {w}x{w} "
          f"{spp}spp rr{POOL['z_rr_depth']}, {r} seeds from 100",
          "nvidia_smi": smi, "per_pixel": {"mean_and_se": pp,
                                           "wall_s": walls["per_pixel"]},
          **out, "gated": "pool_of_w_h", "launches": launches}, t0)
    if out["pool_of_w_h"]["z_vs_per_pixel"] >= 4.0:
        raise AssertionError(f"pooled and per-pixel means disagree at a "
                             f"pool of W*H: {out}")
    return launches


def phase_pool_large(large, cam_large, device, smi):
    """The pool on the large scene (64x64, rr_depth 8, a pool of 16)
    through K3/K4: 15 K3 and 15 K4 launches a sample (the pair set fits
    one connect chunk); held to the render through their plain
    versions."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.camera import Camera
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig

    w, spp = POOL_LARGE["width"], POOL_LARGE["spp"]
    cam = Camera.make(cam_large.o, cam_large.at, cam_large.up, cam_large.fov,
                      w, w)
    cfg = BDPTConfig(w, w, spp=spp, rr_depth=BENCH["rr_depth"],
                     light_pool=POOL_LARGE["light_pool"])
    cc = cam.device_constants(device)
    key = rng.key(SEED, device)
    config = (f"large scene {w}x{w} {spp}spp rr{cfg.rr_depth} light_pool "
              f"{cfg.light_pool}")
    l = cfg.n_steps
    _, launches = render_phase(
        "pool_large", "large", config,
        lambda: _pool_render(large, cc, cfg, key, spp), spp,
        {"k3_closest_hit_stream": 1 + 2 * l, "k4_any_hit_stream": 2 * l + 1},
        smi)
    compare_renders("pool large scene, K3/K4", config,
                    lambda: _pool_render(large, cc, cfg, key, spp),
                    _plain_routes("k3", "k4"))
    return launches


def phase_sharded(scene, cam, device, smi, mesh):
    """render_image_sharded on the bench configuration (SHARDED_SPP spp)
    at world size 1 over NCCL, in both framebuffer merges, against
    render_image at the same samples (chunks of 4, one sample a batch),
    which runs first and last: the aggregate gate, 8 K1 and 1 K2 launches
    a sample (the primaries, 7 walk depths, the mega connect), and each
    sharded wall over the unsharded one."""
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu_torch.parallel.mesh import FB_MODES, render_image_sharded

    t0 = time.perf_counter()
    cfg = BDPTConfig(BENCH["width"], BENCH["height"], spp=SHARDED_SPP,
                     rr_depth=BENCH["rr_depth"])
    runs = {"render_image": []}
    unsharded = lambda: render_image(scene, cam, cfg, seed=SEED)
    ref = counted(unsharded)
    runs["render_image"].append(ref[2])
    launches, out_modes = {}, {}
    for mode in FB_MODES:
        img, nr, wall, ln, plain_calls, peak = counted(
            lambda: render_image_sharded(scene, cam, cfg, mesh, seed=SEED,
                                         fb_mode=mode))
        add_launches(launches, ln)
        out_modes[mode] = {"wall_s": wall, "nrays": nr,
                           "rays_per_s": nr / wall, "peak_mem_bytes": peak,
                           "launches": ln, "plain_calls_on_cuda": plain_calls,
                           **image_agreement(img.reshape(-1, 3), nr,
                                             ref[0].reshape(-1, 3), ref[1])}
    runs["render_image"].append(counted(unsharded)[2])
    base = statistics.mean(runs["render_image"])
    for v in out_modes.values():
        v["wall_over_unsharded"] = v["wall_s"] / base
    out = {"phase": "sharded", "config": f"procedural glass cbox "
           f"{cfg.width}x{cfg.height} {cfg.spp}spp rr{cfg.rr_depth}, mesh "
           f"1x1 NCCL against render_image, seed{SEED}", "nvidia_smi": smi,
           "render_image_wall_s": runs["render_image"], "nrays": ref[1],
           "modes": out_modes, "launches": launches,
           "image_mean": float(ref[0].mean())}
    emit(out, t0)
    for mode, v in out_modes.items():
        if v["plain_calls_on_cuda"] or not agrees(v):
            raise AssertionError(f"sharded {mode} disagrees with "
                                 f"render_image: {v}")
        if (v["launches"]["k1_closest_hit"], v["launches"]["k2_any_hit"]) \
                != ((cfg.n_steps + 1) * cfg.spp, cfg.spp):
            raise AssertionError(f"sharded {mode} launched {v['launches']}")
    return launches


def _z(a, b):
    """|z| of the difference of two (mean, standard error) pairs."""
    return abs(a[0] - b[0]) / (a[1] ** 2 + b[1] ** 2 + 1e-30) ** 0.5


def phase_modes(device, smi):
    """The cross-estimator check of tests/test_bdpt.py on the card: BDPT,
    the path tracer and the light tracer on the all-diffuse box (64x64)
    over MODES["replicates"] disjoint seeds, image means compared by z.

    Without Russian roulette each walk stops after rr_depth - 1 steps.
    The path and light tracers then see paths of up to rr_depth - 1
    surface vertices; BDPT also connects eye and light walks into longer
    ones, and at rr_depth - 1 vertices it lacks the s=0 technique (an
    emitter hit one step past the walk) that its MIS weights count.  At
    rr_depth 3 the three estimate different truncations: BDPT's mean is
    printed, only the path and light tracers are gated.  At
    MODES["deep_rr_depth"] those paths carry too little light to show, so
    all three must agree; a gap there would be a bias of the weights, not
    of the truncation.  With Russian roulette (MODES["max_bounces"]
    bounces) all three must agree as well.  Then light_trace and
    path_trace renders of the glass bench box through K1/K2, each held to
    its render through their plain versions."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    t0 = time.perf_counter()
    w, spp, r = MODES["width"], MODES["spp"], MODES["replicates"]
    scene, _, cam = cornell_box_scene(w, w, device=device)
    cam_consts = cam.device_constants(device)
    out = {"phase": "modes",
           "config": f"all-diffuse cbox {w}x{w} {spp}spp sb{spp}, {r} seeds "
                     f"from 100; no_rr at rr_depth {MODES['rr_depth']} and "
                     f"{MODES['deep_rr_depth']}, RR from rr_depth "
                     f"{MODES['rr_depth']} to {MODES['max_bounces']} bounces",
           "nvidia_smi": smi}
    launches = {}
    settings = (("no_rr", dict(rr_depth=MODES["rr_depth"])),
                ("no_rr_deep", dict(rr_depth=MODES["deep_rr_depth"])),
                ("rr", dict(rr_depth=MODES["rr_depth"], no_rr=False,
                            max_bounces=MODES["max_bounces"])))
    for setting, extra in settings:
        stats, walls, nrays = {}, {}, {}
        for mode in ("bdpt", "path_trace", "light_trace"):
            cfg = BDPTConfig(w, w, spp=spp, mode=mode, **extra)
            m, walls[mode], nrays[mode] = [], 0.0, 0
            for i in range(r):
                fb, nr, wall, ln, plain_calls, _ = _timed_chunk(
                    scene, cam_consts, cfg, rng.key(100 + i, device), spp,
                    spp)
                if plain_calls or not bool(torch.isfinite(fb).all()) \
                        or float(fb.min()) < 0.0:
                    raise AssertionError(f"{mode}: plain calls {plain_calls}"
                                         f" or non-finite or negative pixels")
                m.append(float(fb.double().mean()))
                walls[mode] += wall
                nrays[mode] += nr
                add_launches(launches, ln)
            stats[mode] = (statistics.mean(m),
                           statistics.stdev(m) / len(m) ** 0.5)
        out[setting] = {
            "mean_and_se": stats,
            "z": {"bdpt_vs_path_trace": _z(stats["bdpt"],
                                           stats["path_trace"]),
                  "bdpt_vs_light_trace": _z(stats["bdpt"],
                                            stats["light_trace"]),
                  "path_trace_vs_light_trace": _z(stats["path_trace"],
                                                  stats["light_trace"])},
            "bdpt_rel_gap": {k: stats["bdpt"][0] / stats[k][0] - 1.0
                             for k in ("path_trace", "light_trace")},
            "wall_s": walls, "nrays": nrays,
            "rays_per_s": {k: nrays[k] / walls[k] for k in walls}}
    out["launches"] = launches
    emit(out, t0)
    if min(launches["k1_closest_hit"], launches["k2_any_hit"]) <= 0 or any(
            n for k, n in launches.items()
            if k not in ("k1_closest_hit", "k2_any_hit")):
        raise AssertionError(f"modes launched {launches}")
    gated = [out["no_rr"]["z"]["path_trace_vs_light_trace"]]
    gated += [z for k in ("no_rr_deep", "rr") for z in out[k]["z"].values()]
    if max(gated) >= 4.0:
        raise AssertionError(f"the estimators disagree: {out}")
    w = SMALL["width"]
    scene, _, cam = cornell_box_scene(w, w, device=device,
                                      right_object="glass_sphere",
                                      sphere_subdiv=3)
    for mode in ("light_trace", "path_trace"):
        compare_paths(f"glass box {mode}, K1/K2", scene, cam,
                      BDPTConfig(w, w, spp=SMALL["spp"],
                                 rr_depth=SMALL["rr_depth"], mode=mode),
                      dict(closest_hit=tc.closest_hit_plain,
                           any_hit=ta.any_hit_plain))
    return launches


def _plain_routes(*kernels):
    """The plain versions of `kernels` ("k1".."k4") as accel/api.py
    routes, for mock.patch."""
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc

    routes = {"k1": dict(closest_hit=tc.closest_hit_plain),
              "k2": dict(any_hit=ta.any_hit_plain),
              "k3": dict(closest_hit_stream=tc.closest_hit_stream_plain),
              "k4": dict(any_hit_stream=ta.any_hit_stream_plain)}
    return {k: v for name in kernels for k, v in routes[name].items()}


def render_phase(phase, case, config, render, spp, expect, smi,
                 profile=None, **extra):
    """One timed render() -> (image, nrays) of `spp` samples, launch
    counts reset just before it and read just after, checked as
    check_render checks a path; `expect` maps each kernel of the path to
    its launches a sample, an int (exact) or a (low, high) range.
    profile: optional (run one batch, samples in it) for the device
    busy time and idle share.  Returns (its phase line, its launches)."""
    t0 = time.perf_counter()
    img, nrays, wall, launches, plain_calls, peak = counted(render)
    per_sample = {k: n / spp for k, n in launches.items() if n}
    lanes = img.numel() // 3 * spp
    out = {"phase": phase, "case": case, "config": config, "nvidia_smi": smi,
           "wall_s": wall, "nrays": nrays, "rays_per_s": nrays / wall,
           "lanes_traced_per_s": lanes * sum(launches.values()) / spp / wall,
           "peak_mem_bytes": peak, "launches": launches,
           "launches_per_sample": per_sample,
           "plain_calls_on_cuda": plain_calls,
           "image_mean": float(img.double().mean()),
           "finite": bool(torch.isfinite(img).all()), **extra}
    if profile is not None:
        run, samples = profile
        out.update(_profile_run(run, wall * samples / spp))
    emit(out, t0)
    check_render(out, used=tuple(expect))
    for k, want in expect.items():
        lo, hi = (want, want) if isinstance(want, int) else want
        if not lo <= per_sample[k] <= hi:
            raise AssertionError(f"{phase} {case}: {per_sample[k]} {k} "
                                 f"launches a sample, expected {want}")
    return out, launches


def phase_path(scene, cam, device, smi, name="bench", kernel="k1",
               spp=None):
    """The explicit path tracer with the scene file's defaults (Russian
    roulette from depth 5, 32 bounces, one emitter sample, no BSDF
    sample) at 256x256, one sample a batch, through `kernel` (K1 on the
    bench scene, K3 on the large one).  Without the early ends of its
    loops a sample runs PATH_K1_MAX closest-hit launches.  Held to its
    render through the plain version at 64x64 (32x32 on the large
    scene)."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.camera import Camera
    from bpt_tpu_torch.integrators.path import PathConfig, \
        render_chunk_path, render_image_path

    w, spp = OTHER["width"], spp or OTHER["spp"]
    cfg = PathConfig(w, w, spp)
    cam_consts = cam.device_constants(device)
    key = rng.key(SEED, device)
    tw = time.perf_counter()
    render_chunk_path(scene, cam_consts, cfg, key, 1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - tw
    counter = {"k1": "k1_closest_hit", "k3": "k3_closest_hit_stream"}[kernel]
    out, launches = render_phase(
        "path" if name == "bench" else "path_large", name,
        f"{name} scene {w}x{w} {spp}spp, path defaults (RR from depth "
        f"{cfg.rr_depth}, {cfg.max_bounces} bounces), sb1, seed{SEED}",
        lambda: render_chunk_path(scene, cam_consts, cfg, key, spp), spp,
        {counter: (2, PATH_K1_MAX)}, smi,
        profile=(lambda: render_chunk_path(scene, cam_consts, cfg, key, 1), 1),
        warmup_s=warm_s, k1_launches_without_early_ends=PATH_K1_MAX)
    ws = OTHER["plain_width"] if name == "bench" else SMALL_LARGE["width"]
    cam_s = Camera.make(cam.o, cam.at, cam.up, cam.fov, ws, ws)
    cfg_s = PathConfig(ws, ws, OTHER["plain_spp"])
    compare_renders(f"path {name}, {kernel.upper()}",
                    f"{ws}x{ws} {cfg_s.spp}spp path defaults",
                    lambda: render_image_path(scene, cam_s, cfg_s, seed=SEED),
                    _plain_routes(kernel))
    return launches


# K1 launches a sample of each direct strategy: the primary rays, one
# shadow or emitter trace, and for mis also the BSDF sample's trace.
DIRECT_K1 = {"area": 2, "solidAngle": 2, "cosineHemisphere": 2, "bsdf": 2,
             "mis": 3}


def phase_direct(scene, meta, cam, smi):
    """The five strategies of integrators/direct.py on the bench scene at
    256x256, 4 spp, each held to its render through K1's plain version
    at 64x64."""
    from bpt_tpu_torch.core.camera import Camera
    from bpt_tpu_torch.integrators.direct import DirectConfig, \
        render_image_direct

    w, spp, ws = OTHER["width"], OTHER["spp"], OTHER["plain_width"]
    cam_w = Camera.make(cam.o, cam.at, cam.up, cam.fov, w, w)
    cam_s = Camera.make(cam.o, cam.at, cam.up, cam.fov, ws, ws)
    launches = {}
    for strategy, k1 in DIRECT_K1.items():
        cfg = DirectConfig(w, w, spp, strategy=strategy)
        _, ln = render_phase(
            "direct", strategy, f"bench scene {w}x{w} {spp}spp seed{SEED}",
            lambda: render_image_direct(scene, meta, cam_w, cfg, seed=SEED),
            spp, {"k1_closest_hit": k1}, smi)
        add_launches(launches, ln)
        cfg_s = DirectConfig(ws, ws, OTHER["plain_spp"], strategy=strategy)
        compare_renders(f"direct {strategy}, K1",
                        f"{ws}x{ws} {cfg_s.spp}spp",
                        lambda: render_image_direct(scene, meta, cam_s, cfg_s,
                                                    seed=SEED),
                        _plain_routes("k1"))
    return launches


def phase_misc(scene, meta, cam, smi, name="bench",
               integrators=("normal", "simple", "ao", "ro"),
               kernels=("k1", "k2")):
    """The integrators of integrators/misc.py at 256x256, 4 spp: one
    closest-hit launch a sample (the primary rays) and, but for normal,
    one any-hit launch; each held to its render through the plain
    versions at 64x64 (32x32 on the large scene)."""
    from bpt_tpu_torch.core.camera import Camera
    from bpt_tpu_torch.integrators.misc import MiscConfig, render_image_misc

    w, spp = OTHER["width"], OTHER["spp"]
    ws = OTHER["plain_width"] if name == "bench" else SMALL_LARGE["width"]
    cam_w = Camera.make(cam.o, cam.at, cam.up, cam.fov, w, w)
    cam_s = Camera.make(cam.o, cam.at, cam.up, cam.fov, ws, ws)
    counter = {"k1": "k1_closest_hit", "k2": "k2_any_hit",
               "k3": "k3_closest_hit_stream", "k4": "k4_any_hit_stream"}
    launches = {}
    for integrator in integrators:
        cfg = MiscConfig(w, w, spp, integrator=integrator)
        used = kernels[:1] if integrator == "normal" else kernels
        _, ln = render_phase(
            "misc", f"{integrator} ({name})",
            f"{name} scene {w}x{w} {spp}spp seed{SEED}",
            lambda: render_image_misc(scene, meta, cam_w, cfg, seed=SEED),
            spp, {counter[k]: 1 for k in used}, smi)
        add_launches(launches, ln)
        cfg_s = MiscConfig(ws, ws, OTHER["plain_spp"], integrator=integrator)
        compare_renders(f"misc {integrator} ({name}), "
                        f"{'/'.join(k.upper() for k in used)}",
                        f"{ws}x{ws} {cfg_s.spp}spp",
                        lambda: render_image_misc(scene, meta, cam_s, cfg_s,
                                                  seed=SEED),
                        _plain_routes(*used))
    return launches


def phase_integrators_xest(device, smi):
    """The explicit path tracer (NEE and MIS: one emitter and one BSDF
    sample, roulette from depth 5) against BDPT with roulette from
    rr_depth 3, both to 16 bounces, on the all-diffuse box (64x64, 8 spp
    in one batch, 6 seeds from 100, as phase `modes`): the two image
    means must agree, |z| < 4."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig
    from bpt_tpu_torch.integrators.path import PathConfig, render_chunk_path
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    t0 = time.perf_counter()
    w, spp, r = XEST["width"], XEST["spp"], XEST["replicates"]
    scene, _, cam = cornell_box_scene(w, w, device=device)
    cam_consts = cam.device_constants(device)
    bdpt_cfg = BDPTConfig(w, w, spp=spp, rr_depth=XEST["bdpt_rr_depth"],
                          no_rr=False, max_bounces=XEST["max_bounces"])
    path_cfg = PathConfig(w, w, spp, rr_depth=XEST["path_rr_depth"],
                          max_bounces=XEST["max_bounces"], bsdf_samples=1)
    means = {"bdpt": [], "path": []}
    walls = {"bdpt": 0.0, "path": 0.0}
    nrays = {"bdpt": 0, "path": 0}
    launches = {}
    for i in range(r):
        key = rng.key(100 + i, device)
        runs = {"bdpt": _timed_chunk(scene, cam_consts, bdpt_cfg, key, spp,
                                     spp),
                "path": counted(lambda: render_chunk_path(
                    scene, cam_consts, path_cfg, key, spp,
                    samples_per_batch=spp))}
        for est, (fb, nr, wall, ln, plain_calls, _) in runs.items():
            if plain_calls or not bool(torch.isfinite(fb).all()) \
                    or float(fb.min()) < 0.0:
                raise AssertionError(f"{est}: plain calls {plain_calls} or "
                                     f"non-finite or negative pixels")
            means[est].append(float(fb.double().mean()))
            walls[est] += wall
            nrays[est] += nr
            add_launches(launches, ln)
    stats = {k: (statistics.mean(m), statistics.stdev(m) / len(m) ** 0.5)
             for k, m in means.items()}
    out = {"phase": "integrators_xest",
           "config": f"all-diffuse cbox {w}x{w} {spp}spp sb{spp}, {r} seeds "
                     f"from 100; path: NEE + 1 BSDF sample, RR from depth "
                     f"{path_cfg.rr_depth}; bdpt: RR from rr_depth "
                     f"{bdpt_cfg.rr_depth}; both {XEST['max_bounces']} "
                     f"bounces", "nvidia_smi": smi,
           "mean_and_se": stats, "z": _z(stats["bdpt"], stats["path"]),
           "path_rel_gap": stats["path"][0] / stats["bdpt"][0] - 1.0,
           "wall_s": walls, "nrays": nrays,
           "rays_per_s": {k: nrays[k] / walls[k] for k in walls},
           "launches": launches}
    emit(out, t0)
    if min(launches["k1_closest_hit"], launches["k2_any_hit"]) <= 0 or any(
            n for k, n in launches.items()
            if k not in ("k1_closest_hit", "k2_any_hit")):
        raise AssertionError(f"integrators_xest launched {launches}")
    if out["z"] >= 4.0:
        raise AssertionError(f"the path tracer and BDPT disagree: {out}")
    return launches


def run_cli(case, toml_path, *args):
    """`python -m bpt_tpu_torch.cli toml_path *args` in a subprocess: it
    must exit 0, its EXR (beside the scene file) must be finite, square at
    the scene's width and not black, and its meta.json must name the card
    and one device.  Returns (image, stdout, the run's line)."""
    import numpy as np

    from bpt_tpu_torch.io.exr import read_exr
    from bpt_tpu_torch.scene.toml_config import load_toml

    repo = os.path.dirname(os.path.abspath(__file__))
    card = torch.cuda.get_device_name(0)
    w = load_toml(toml_path).width
    tw = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "bpt_tpu_torch.cli", toml_path, *args],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
        text=True, timeout=CLI["timeout_s"])
    wall = time.perf_counter() - tw
    if run.returncode != 0:
        raise AssertionError(f"cli {case} exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    exr = os.path.splitext(toml_path)[0] + ".exr"
    img = read_exr(exr)
    with open(exr + ".meta.json") as f:
        meta = json.load(f)
    line = {"process_s": wall, "render_s": meta["wall_s"],
            "rays": meta["rays"], "rays_per_s": meta["rays_per_sec"],
            "image_mean": float(img.mean()), "device": meta["device"],
            "frames": meta.get("frames"),
            "stdout_tail": run.stdout.strip()[-300:]}
    if img.shape != (w, w, 3) or not np.isfinite(img).all() \
            or img.mean() <= 0.0:
        raise AssertionError(f"cli {case}: bad image {img.shape}")
    if meta["device"] != card or meta["n_devices"] != 1:
        raise AssertionError(f"cli {case}: meta names {meta['device']!r}, "
                             f"the card {card!r}")
    return img, run.stdout, line


def phase_cli(smi):
    """`python -m bpt_tpu_torch.cli` in a subprocess on scene files written
    by export_cornell_box (the glass box, 512x512): bdpt with
    --checkpoint, then resumed from the finished checkpoint (the same
    image, no sample rendered); path (the scene file's defaults); direct
    with samplingStrategy = "mis"; ao, each checked by run_cli."""
    import numpy as np

    from bpt_tpu_torch.scene.export import export_cornell_box

    t0 = time.perf_counter()
    w = CLI["width"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def scene_file(name, integrator, spp, extra="", **kw):
            path = export_cornell_box(
                os.path.join(tmp, name), width=w, height=w, spp=spp,
                integrator=integrator, right_object="glass_sphere",
                sphere_subdiv=3, **kw)
            with open(path, "a") as f:
                f.write(extra)
            return path

        def cli(case, toml_path, *args):
            img, stdout, runs[case] = run_cli(case, toml_path, *args)
            return img, stdout

        bdpt = scene_file("bdpt", "bdpt", CLI["bdpt_spp"])
        ck = os.path.join(tmp, "bdpt.ckpt")
        first, _ = cli("bdpt", bdpt, "--checkpoint", ck, "--spp-chunk", "2")
        again, stdout = cli("bdpt_resumed", bdpt, "--checkpoint", ck,
                            "--spp-chunk", "2")
        if f"resumed at {CLI['bdpt_spp']}/{CLI['bdpt_spp']} spp" not in \
                stdout or not np.array_equal(first, again):
            raise AssertionError("the resumed bdpt render is not the "
                                 "checkpointed one")
        cli("path", scene_file("path", "path", CLI["spp"], rr_depth=5))
        cli("direct_mis", scene_file("direct", "direct", CLI["spp"],
                                     'samplingStrategy = "mis"\n'))
        cli("ao", scene_file("ao", "ao", CLI["spp"]))
    emit({"phase": "cli", "config": f"python -m bpt_tpu_torch.cli, glass box "
          f"{w}x{w} scene files, seed 0", "nvidia_smi": smi, "runs": runs},
         t0)


# tests/test_grad.py's checks on the card (phase grad): the glass box at
# 64x64, 4 spp, rr_depth 3, gradients of 2-sample chunks at key 11; the
# large scene at 64x64, 1 spp; the bench settings' 2-sample chunk (one
# batch of 2 samples) for the backward pass's wall and memory.
GRAD = dict(width=64, spp=4, rr_depth=3, spp_chunk=2, seed=11,
            large_spp=1, fd_eps=1e-2, rel_to_plain=1e-4)
GRAD_MODES = {"bdpt": {}, "path_trace": dict(mode="path_trace"),
              "light_trace": dict(mode="light_trace"),
              "rr": dict(no_rr=False, rr_depth=2, max_bounces=6)}
# (field, index): the floor's red albedo, the light's green emission.
GRAD_FD = (("diffuse", (0, 0)), ("emission", (5, 1)))
# BASELINE config #5 (probes/inverse_recover.py) for a few iterations.
INVERSE = dict(res=1024, iters=10, spp=2, lr=0.2)
# The realtime passes at 256x256: frames a pass (gi runs the path tracer
# with a scene file's defaults, seconds a frame), and the fly script.
REALTIME = dict(width=256, frames=16, gi_frames=3, plain_frames=2,
                fly="..w..H+4;.P-3;..", cli_frames=4)


def _grad_case(scene, cc, cfg, key, spp_chunk, routes, used):
    """loss_and_grad through the kernels (launch counts reset just before
    and read just after, checked against `used` and G1) and through the
    plain versions `routes` and G1's plain version; each field's gradient
    held to the plain one within GRAD["rel_to_plain"] of its norm.
    Returns (the case's line, its launches, the kernels' (loss,
    grads))."""
    from unittest import mock

    import numpy as np

    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.diff.grad import extract_params, loss_and_grad
    from bpt_tpu_torch.ops import gather

    used = (*used, "g1_gather_rows_backward")

    params = extract_params(scene)
    target = torch.zeros((cfg.width * cfg.height, 3), device=cc["o"].device)
    (loss, g), _, wall, launches, plain_calls, peak = counted(
        lambda: (loss_and_grad(params, scene, cc, cfg, key, spp_chunk,
                               target), 0))
    with mock.patch.multiple(api, **routes), mock.patch.object(
            gather, "gather_rows_backward",
            lambda ids, grads, m: gather.gather_rows_backward_plain(
                ids.long(), grads, m)):
        loss_p, g_p = loss_and_grad(params, scene, cc, cfg, key, spp_chunk,
                                    target)
    rel = {}
    for f, v in g.items():
        norm = float(torch.linalg.vector_norm(g_p[f].double()))
        diff = float(torch.linalg.vector_norm((v - g_p[f]).double()))
        rel[f] = diff / norm if norm > 0.0 else diff
    out = {"loss": float(loss), "loss_plain": float(loss_p),
           "grad_norm": {f: float(torch.linalg.vector_norm(v.double()))
                         for f, v in g.items()},
           "grad_rel_to_plain": rel, "wall_s": wall, "peak_mem_bytes": peak,
           "launches": launches, "plain_calls_on_cuda": plain_calls,
           "finite": bool(np.isfinite(float(loss))) and all(
               bool(torch.isfinite(v).all()) for v in g.values())}
    if not out["finite"] or plain_calls:
        raise AssertionError(f"grad: non-finite or plain calls {out}")
    if min(launches[k] for k in used) <= 0 or any(
            n for k, n in launches.items() if k not in used):
        raise AssertionError(f"grad: launched {launches}, expected {used}")
    if max(rel.values()) > GRAD["rel_to_plain"]:
        raise AssertionError(f"grad: kernels and plain versions disagree "
                             f"{rel}")
    if out["grad_norm"]["emission"] <= 0.0:
        raise AssertionError("grad: no emission gradient")
    return out, launches, (loss, g)


def phase_grad_large(large, cam_large, device, smi):
    """Gradients of a 1-spp render of the large scene at 64x64 through K3
    and K4, held to the same through their plain versions."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.camera import Camera
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig

    t0 = time.perf_counter()
    w = GRAD["width"]
    cam = Camera.make(cam_large.o, cam_large.at, cam_large.up,
                      cam_large.fov, w, w)
    cfg = BDPTConfig(w, w, spp=GRAD["large_spp"], rr_depth=GRAD["rr_depth"])
    out, launches, _ = _grad_case(
        large, cam.device_constants(device), cfg, rng.key(GRAD["seed"],
                                                          device),
        GRAD["large_spp"], _plain_routes("k3", "k4"),
        ("k3_closest_hit_stream", "k4_any_hit_stream"))
    emit({"phase": "grad_large", "config": f"large scene {w}x{w} "
          f"{cfg.spp}spp rr{cfg.rr_depth} seed{GRAD['seed']}",
          "nvidia_smi": smi, **out}, t0)
    return launches


def _bench_backward(scene, cam, device):
    """Forward and backward of one 2-sample chunk at the bench settings
    (256x256, rr_depth 8, both samples in one batch): walls and peak
    memory, with the same chunk's forward without autograd beside
    them."""
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.diff.grad import apply_params, extract_params
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk

    cfg = BDPTConfig(BENCH["width"], BENCH["height"], spp=BENCH["spp"],
                     rr_depth=BENCH["rr_depth"])
    cc = cam.device_constants(device)
    key = rng.key(SEED, device)
    n = BENCH["sb"]
    target = torch.zeros((cfg.width * cfg.height, 3), device=device)

    def step():
        leaves = {f: p.detach().requires_grad_(True)
                  for f, p in extract_params(scene).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        tw = time.perf_counter()
        fb, _ = render_chunk(apply_params(scene, leaves), cc, cfg, key, n,
                             samples_per_batch=n)
        loss = torch.mean((fb * (cfg.spp / n) - target) ** 2)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - tw
        peak_fwd = torch.cuda.max_memory_allocated()
        tw = time.perf_counter()
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        t_bwd = time.perf_counter() - tw
        launches, _ = read_counts()
        return {"forward_s": t_fwd, "backward_s": t_bwd,
                "peak_mem_bytes_after_forward": peak_fwd,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                "launches": launches,
                "finite": all(g is None or bool(torch.isfinite(g).all())
                              for g in grads)}

    def forward_only():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tw = time.perf_counter()
        render_chunk(scene, cc, cfg, key, n, samples_per_batch=n)
        torch.cuda.synchronize()
        return {"forward_no_grad_s": time.perf_counter() - tw,
                "peak_mem_bytes_no_grad": torch.cuda.max_memory_allocated()}

    step()
    out = {**step(), **forward_only(),
           "config": f"bench scene {cfg.width}x{cfg.height} chunk of {n} "
                     f"samples in one batch, rr{cfg.rr_depth}"}
    torch.cuda.empty_cache()
    if not out["finite"]:
        raise AssertionError(f"grad bench: non-finite gradients {out}")
    return out


def phase_grad(scene, cam, device, smi):
    """tests/test_grad.py's checks through K1/K2 on the glass box at
    64x64: finite gradients in every mode and with Russian roulette, each
    field's gradient held to the plain routes', autograd against central
    finite differences at common random numbers (eps 1e-2, rtol 0.05,
    atol 1e-4); then the bench chunk's backward pass."""
    import numpy as np

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.diff.grad import extract_params, \
        finite_difference_check
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    t0 = time.perf_counter()
    w, chunk = GRAD["width"], GRAD["spp_chunk"]
    box, _, box_cam = cornell_box_scene(w, w, device=device,
                                        right_object="glass_sphere",
                                        sphere_subdiv=3)
    cc = box_cam.device_constants(device)
    key = rng.key(GRAD["seed"], device)
    used = ("k1_closest_hit", "k2_any_hit")
    cases, launches = {}, {}
    for mode, change in GRAD_MODES.items():
        cfg = BDPTConfig(w, w, **{"spp": GRAD["spp"],
                                  "rr_depth": GRAD["rr_depth"], **change})
        cases[mode], ln, lg = _grad_case(box, cc, cfg, key, chunk,
                                         _plain_routes("k1", "k2"), used)
        add_launches(launches, ln)
        if mode == "bdpt":
            cfg_bdpt, (_, g_bdpt) = cfg, lg
    params = extract_params(box)
    target = torch.zeros((w * w, 3), device=device)
    fd = {}
    for field, idx in GRAD_FD:
        d, _, _, ln, plain_calls, _ = counted(lambda: (
            finite_difference_check(params, box, cc, cfg_bdpt, key, chunk,
                                    target, field, idx, eps=GRAD["fd_eps"]),
            0))
        add_launches(launches, ln)
        ad = float(g_bdpt[field][idx])
        fd[f"{field}{list(idx)}"] = {"fd": float(d), "autograd": ad}
        if plain_calls or not np.isclose(float(d), ad, rtol=0.05,
                                         atol=1e-4):
            raise AssertionError(f"grad: FD {float(d)} against autograd "
                                 f"{ad} on {field}{idx}")
    bench = _bench_backward(scene, cam, device)
    add_launches(launches, bench["launches"])
    emit({"phase": "grad", "config": f"glass cbox {w}x{w} spp "
          f"{GRAD['spp']} rr{GRAD['rr_depth']} chunks of {chunk} seed "
          f"{GRAD['seed']}", "nvidia_smi": smi, "modes": cases,
          "finite_difference": fd, "bench_chunk": bench}, t0)
    return launches


def phase_inverse(device, smi):
    """BASELINE config #5 (probes/inverse_recover.py: 1024x1024, spp 2,
    rr_depth 2, lr 0.2, from albedo 0.5 and emission x0.3) for
    INVERSE["iters"] iterations of recover_materials through K1/K2: the
    losses, step time, peak memory and one profiled step.  The probe
    raises unless the last loss is below the first and every gradient is
    finite."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "probes"))
    import inverse_recover

    t0 = time.perf_counter()
    (report, _, wall, launches, plain_calls, _) = counted(
        lambda: (inverse_recover.run(device=device, profile=_profile_run,
                                     **INVERSE), 0))
    used = ("k1_closest_hit", "k2_any_hit", "g1_gather_rows_backward")
    if plain_calls or min(launches[k] for k in used) <= 0 or any(
            n for k, n in launches.items() if k not in used):
        raise AssertionError(f"inverse launched {launches}, plain calls "
                             f"{plain_calls}")
    emit({"phase": "inverse", "nvidia_smi": smi, "wall_s": wall,
          "launches": launches, **report}, t0)
    return launches


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
    spp, rr_depth 2), replayed with the launch counts reset just before:
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
    calls = probe.step_calls(GATHER["res"], device)
    torch.cuda.synchronize()
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
           "calls": len(calls), "launches": launches,
           "plain_calls_on_cuda": plain_calls,
           "lanes_per_call": [c[0].numel() for c in calls],
           "tables_per_call": [len(c[1]) for c in calls],
           "bit_identical": identical,
           "max_rel_err_vs_float64": errs["exact"],
           "max_rel_err_vs_plain": errs["plain"],
           "plain_max_rel_err_vs_float64": errs["plain_exact"],
           "max_abs_err": max_abs,
           **timing}
    emit(out, t0)
    if (plain_calls or not identical or launches["g1_gather_rows_backward"]
            != sum(2 if c[0].numel() else 1 for c in calls)
            or any(n for k, n in launches.items()
                   if k != "g1_gather_rows_backward")
            or errs["exact"] > GATHER["tol_exact"]
            or errs["plain"] > GATHER["tol_plain"]):
        raise AssertionError(f"gather: G1 failed its checks {out}")
    del calls, got, again
    torch.cuda.empty_cache()
    return {"launches_per_step": launches["g1_gather_rows_backward"],
            "max_abs_err": max_abs, "ms": timing["kernel_ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "library_ms": timing["library_ms"]}


# The threefry kernel R1 (phase rng): lanes a timed call, and the bytes a
# lane moves in each call (its key read, its data read, its output written).
# Timed calls cycle through copies of their inputs of at least cold_bytes
# in all, twice the L2 cache, so each call reads its inputs from memory.
RNG = dict(lanes=(131_072, 1_048_576), reps=20, spp=2, cold_bytes=100e6,
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


def phase_rng(scene, cam, device, smi):
    """R1 (csrc/threefry.cu through ops/threefry.py): each call of the
    three RNG functions one launch, bit-equal to its plain version on the
    card, device us a call on RNG['lanes'] lanes (inputs not in L2) beside
    the plain version's and the bound of the bytes it moves; then a bench
    chunk (256x256, 2 spp, rr8, sb 2) with the counts reset just before:
    R1 launches a sample, no plain version on CUDA tensors, and the same
    rays and framebuffer (within the t=1 splats' atomics) as the chunk
    with the three functions swapped for their plain versions."""
    from unittest import mock

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig
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
    cfg = BDPTConfig(BENCH["width"], BENCH["height"], spp=RNG["spp"],
                     rr_depth=BENCH["rr_depth"])
    cc = cam.device_constants(device)
    key = rng.key(SEED, device)
    _timed_chunk(scene, cc, cfg, key, RNG["spp"], BENCH["sb"])
    threefry.threefry_cuda.launches = 0
    fb, nrays, wall, launches, plain_calls, _ = _timed_chunk(
        scene, cc, cfg, key, RNG["spp"], BENCH["sb"])
    r1 = threefry.threefry_cuda.launches
    with mock.patch.multiple(rng, fold_in=rng.fold_in_plain,
                             uniform1=rng.uniform1_plain,
                             uniform2=rng.uniform2_plain):
        fb_p, nrays_p, wall_p, _, plain_p, _ = _timed_chunk(
            scene, cc, cfg, key, RNG["spp"], BENCH["sb"])
    fb_gap = float((fb - fb_p).abs().max() / fb_p.abs().mean())
    out = {"phase": "rng", "nvidia_smi": smi, "launches_per_call": per_call,
           "bit_equal": equal, "us_per_call": us, "plain_us_per_call":
           plain_us, "bound_us": bound_us, "kernels_per_call": kernels,
           "plain_kernels_per_call": plain_kernels,
           "host_us_per_call": host_us, "plain_host_us_per_call":
           plain_host_us,
           "share_of_bound": {k: bound_us[k] / us[k] for k in us},
           "chunk": f"{BENCH['width']}x{BENCH['height']} spp {RNG['spp']} "
                    f"rr{BENCH['rr_depth']} sb {BENCH['sb']}",
           "r1_launches_per_sample": r1 / RNG["spp"],
           "trace_launches": launches, "plain_calls_on_cuda": plain_calls,
           "plain_route_calls_on_cuda": plain_p, "nrays": nrays,
           "nrays_plain_route": nrays_p, "fb_gap": fb_gap,
           "wall_s": wall, "wall_s_plain_route": wall_p}
    emit(out, t0)
    if (not equal or set(per_call.values()) != {1}
            or not all(0.9 <= k <= 1 for k in kernels.values()) or plain_calls
            or not plain_p or nrays != nrays_p or fb_gap > 1e-5 or not r1):
        raise AssertionError(f"rng: R1 failed its checks {out}")
    big = RNG["lanes"][-1]
    return {"launches": r1, "launches_per_sample": r1 / RNG["spp"],
            "ms": {k: us[f"{k}.{big}"] / 1e3 for k in calls},
            "plain_ms": {k: plain_us[f"{k}.{big}"] / 1e3 for k in calls},
            "bound_ms": {k: bound_us[f"{k}.{big}"] / 1e3 for k in calls}}


def phase_realtime(scene, meta, cam, device, smi):
    """realtime.py's frame loop on the bench scene at 256x256: each pass
    (normal, simple, ssao, gi) for a run of frames with real EXR writes,
    ms a frame and frames/s, K1/K2 launches a frame; the simple pass held
    to its frames through the plain versions (0 pixels off); the fly
    script through run_interactive; then one `python -m
    bpt_tpu_torch.cli` process on a realtime = true scene file."""
    from unittest import mock

    import numpy as np

    from bpt_tpu_torch import realtime
    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.core.camera import Camera
    from bpt_tpu_torch.io.exr import read_exr, write_exr
    from bpt_tpu_torch.scene.export import export_cornell_box
    from bpt_tpu_torch.scene.toml_config import RenderConfig

    t0 = time.perf_counter()
    w = REALTIME["width"]
    cam_w = Camera.make(cam.o, cam.at, cam.up, cam.fov, w, w)

    def config(pass_type, frames):
        return RenderConfig(toml_file="<chip_smoke>", obj_file="<procedural>",
                            camera=cam_w, width=w, height=w, spp=frames,
                            integrator=pass_type, realtime=True)

    expect = {"normal": {"k1_closest_hit": 1},
              "simple": {"k1_closest_hit": 1, "k2_any_hit": 1},
              "ssao": {"k1_closest_hit": 1, "k2_any_hit": 1},
              "gi": {"k1_closest_hit": (2, PATH_K1_MAX)}}
    passes, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "realtime.exr")
        stamps = []

        def stamped_write(path, img):
            write_exr(path, img)
            stamps.append(time.perf_counter())

        def frames_run(render):
            stamps.clear()
            tw = time.perf_counter()
            img, _, _, ln, plain_calls, peak = counted(
                lambda: (render(), 0))
            ms = np.diff([tw] + stamps) * 1e3
            return img, ln, plain_calls, peak, ms

        for pass_type, want in expect.items():
            n = REALTIME["gi_frames" if pass_type == "gi" else "frames"]
            (img, frames, nrays), ln, plain_calls, peak, ms = frames_run(
                lambda: realtime.run_realtime(
                    scene, meta, config(pass_type, n), out_path, seed=SEED,
                    write_exr=stamped_write))
            steady = ms[1:] if len(ms) > 1 else ms
            passes[pass_type] = {
                "frames": frames, "nrays": nrays,
                "ms_per_frame": float(np.median(steady)),
                "fps": 1e3 / float(np.median(steady)),
                "first_frame_ms": float(ms[0]), "peak_mem_bytes": peak,
                "launches_per_frame": {k: v / frames for k, v in ln.items()
                                       if v},
                "image_mean": float(img.double().mean())}
            add_launches(launches, ln)
            bad = (plain_calls or frames != n or len(ms) != n
                   or not bool(torch.isfinite(img).all())
                   or read_exr(out_path).shape != (w, w, 3))
            for k, v in ln.items():
                lo, hi = ((want[k], want[k]) if isinstance(want.get(k), int)
                          else want.get(k, (0, 0)))
                bad = bad or not lo <= v / frames <= hi
            if bad:
                raise AssertionError(f"realtime {pass_type}: "
                                     f"{passes[pass_type]} {ln}")
        # The simple pass through the plain versions: the same frames.
        n = REALTIME["plain_frames"]
        a, _, _ = realtime.run_realtime(scene, meta, config("simple", n),
                                        out_path, seed=SEED)
        with mock.patch.multiple(api, **_plain_routes("k1", "k2")):
            b, _, _ = realtime.run_realtime(scene, meta, config("simple", n),
                                            out_path, seed=SEED)
        off = image_agreement(a, 0, b, 0)["pixels_off_frac"]
        passes["simple_vs_plain"] = {"frames": n, "pixels_off_frac": off}
        if off != 0.0:
            raise AssertionError(f"realtime simple: {off} of the pixels "
                                 f"off the plain render")
        # The fly script.
        (img, poses), ln, plain_calls, peak, ms = frames_run(
            lambda: realtime.run_interactive(
                scene, meta, config("simple", 1), out_path,
                REALTIME["fly"], seed=SEED, write_exr=stamped_write))
        add_launches(launches, ln)
        passes["fly"] = {"script": REALTIME["fly"],
                         "frames_per_pose": [p for p, _ in poses],
                         "ms_per_frame": float(np.median(ms[1:])),
                         "launches": ln}
        if plain_calls or len(ms) != REALTIME["fly"].count(".") or \
                [p for p, _ in poses] != [2, 1, 1, 1, 1, 1] or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"realtime fly: {passes['fly']}")
        # The command line on a realtime scene file.
        toml_path = export_cornell_box(
            os.path.join(tmp, "rt"), width=w, height=w, spp=8,
            integrator="ssao", right_object="glass_sphere", sphere_subdiv=3,
            realtime=True)
        _, _, passes["cli"] = run_cli("realtime", toml_path, "--frames",
                                      str(REALTIME["cli_frames"]))
        if passes["cli"]["frames"] != REALTIME["cli_frames"]:
            raise AssertionError(f"cli realtime: {passes['cli']}")
    emit({"phase": "realtime", "config": f"bench scene {w}x{w}, one sample "
          f"a frame, seed {SEED}", "nvidia_smi": smi, "passes": passes}, t0)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import bpt_tpu_torch  # noqa: F401  (sets the TF32 switches)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    info = phase_device()
    import torch.distributed as dist

    from bpt_tpu_torch.parallel import mesh as pm

    with tempfile.TemporaryDirectory() as tmp:
        # The device mesh at world size 1 over NCCL (one card): the pool
        # ring and the sharded render run their collectives over one rank.
        pm.init_distributed(f"file://{tmp}/store", 1, 0, backend="nccl")
        try:
            return _phases(device, info, pm.make_mesh())
        finally:
            dist.destroy_process_group()


def _phases(device, info, mesh):
    from bpt_tpu_torch.ops import trace_any as ta
    from bpt_tpu_torch.ops import trace_closest as tc

    smi = info["nvidia_smi"]
    scene, meta, cam = bench_scene(device)
    r1 = phase_rng(scene, cam, device, smi)
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
    large, large_meta, cfg_t = phase_large_scene(device, smi)
    large_rays = compacted_k1_inputs(large, cfg_t.camera, device)
    large_segs = k2_inputs(large, device, n_connect)
    k3 = phase_k3(large, large_rays, scene, bench_rays, info)
    k4 = phase_k4(large, large_segs, scene, bench_segs, info)
    del large_rays, large_segs
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
    # The renders' peak memory counts the scenes and the render only.
    del bench_rays, bench_segs, segs6, scene6
    torch.cuda.empty_cache()

    launches, fb, base = phase_slice(scene, cam, device, smi)
    routed = phase_slice_routed(
        "slice_k5_k7", scene, cam, device, smi,
        dict(closest_hit=tc.closest_hit_full, any_hit=ta.any_hit_compact),
        {"k5_closest_hit_full": "k1_closest_hit",
         "k7_any_hit_compact": "k2_any_hit"}, (fb, base), exact=True)
    launches.update({k: routed[k] for k in ("k5_closest_hit_full",
                                            "k7_any_hit_compact")})
    routed = phase_slice_routed(
        "slice_k6", scene, cam, device, smi,
        dict(closest_hit=tc.closest_hit_sweep),
        {"k6_closest_hit_sweep": "k1_closest_hit", "k2_any_hit": "k2_any_hit"},
        (fb, base), exact=False)
    launches["k6_closest_hit_sweep"] = routed["k6_closest_hit_sweep"]
    k12 = {k: launches[k] for k in ("k1_closest_hit", "k2_any_hit")}
    add_launches(k12, phase_slice_sb4(scene, cam, device, smi, (fb, base)))
    del fb
    add_launches(k12, phase_pool(scene, cam, device, smi, mesh))
    add_launches(k12, phase_sharded(scene, cam, device, smi, mesh))
    k34 = phase_slice_large(large, cfg_t, device, smi)
    phase_paths(device, large, cfg_t.camera)
    add_launches(k34, phase_path(large, cfg_t.camera, device, smi,
                                 name="large", kernel="k3",
                                 spp=PATH_LARGE_SPP))
    add_launches(k34, phase_misc(large, large_meta, cfg_t.camera, smi,
                                 name="large", integrators=("ao",),
                                 kernels=("k3", "k4")))
    add_launches(k34, phase_grad_large(large, cfg_t.camera, device, smi))
    add_launches(k34, phase_pool_large(large, cfg_t.camera, device, smi))
    del large
    torch.cuda.empty_cache()
    add_launches(k12, phase_slice_rr(device, smi))
    add_launches(k12, phase_modes(device, smi))
    add_launches(k12, phase_path(scene, cam, device, smi))
    add_launches(k12, phase_direct(scene, meta, cam, smi))
    add_launches(k12, phase_misc(scene, meta, cam, smi))
    add_launches(k12, phase_integrators_xest(device, smi))
    phase_cli(smi)
    add_launches(k12, phase_grad(scene, cam, device, smi))
    add_launches(k12, phase_inverse(device, smi))
    g1 = phase_gather(device, smi)
    add_launches(k12, phase_realtime(scene, meta, cam, device, smi))
    # The kernels line counts K1-K4 over every path that routes to them.
    launches.update({k: k12[k] for k in ("k1_closest_hit", "k2_any_hit")})
    launches.update({k: k34[k] for k in ("k3_closest_hit_stream",
                                         "k4_any_hit_stream")})
    # G1 runs in every differentiated render: grad, grad_large, inverse.
    launches["g1_gather_rows_backward"] = (
        k12["g1_gather_rows_backward"] + k34["g1_gather_rows_backward"])

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(nvidia_smi_line(), flush=True)
    kernels = [
        ("closest_hit", "closest_hit.cu", "bpt_tpu/ops/pallas_trace.py:296",
         "k1_closest_hit", k1),
        ("any_hit", "any_hit.cu", "bpt_tpu/ops/pallas_sweep.py:216",
         "k2_any_hit", k2),
        ("closest_hit_stream", "closest_hit_stream.cu",
         "bpt_tpu/ops/pallas_sweep.py:289", "k3_closest_hit_stream", k3),
        ("any_hit_stream", "any_hit_stream.cu",
         "bpt_tpu/ops/pallas_sweep.py:235", "k4_any_hit_stream", k4),
        ("closest_hit_full", "closest_hit_full.cu",
         "bpt_tpu/ops/pallas_trace.py:71", "k5_closest_hit_full", k5),
        ("closest_hit_sweep", "closest_hit_sweep.cu",
         "bpt_tpu/ops/pallas_sweep.py:263", "k6_closest_hit_sweep", k6),
        ("any_hit_compact", "any_hit_compact.cu",
         "bpt_tpu/ops/pallas_trace.py:559", "k7_any_hit_compact", k7),
    ]
    rows = []
    for name, src, replaces, count, res in kernels:
        # No single PyTorch call computes a closest hit or an occlusion
        # test over a treelet table, so there is no library time.
        row = {"name": name, "route": "cuda",
               "source": "bpt_tpu_torch/csrc/" + src, "replaces": replaces,
               "launches": launches[count], "max_abs_err": res["max_abs_err"],
               "ms": res["ms"], "plain_ms": res["plain_ms"],
               "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
               "library_ms": None}
        if "flag_mismatch" in res:
            row["flag_mismatch"] = res["flag_mismatch"]
        rows.append(row)
    # G1 replaces no TPU kernel; its library yardstick is autograd's own
    # backward of `table[ids]`.  Its times are over one config #5 step's
    # calls; `launches` counts device kernels (two a call) over the paths.
    rows.append({"name": "gather_rows_backward", "route": "cuda",
                 "source": "bpt_tpu_torch/csrc/gather_backward.cu",
                 "replaces": None, "launches": launches[
                     "g1_gather_rows_backward"],
                 "launches_per_step": g1["launches_per_step"],
                 "max_abs_err": g1["max_abs_err"], "ms": g1["ms"],
                 "plain_ms": g1["plain_ms"], "bound_ms": g1["bound_ms"],
                 "bound_by": "bytes", "library_ms": g1["library_ms"]})
    # R1 replaces no TPU kernel: XLA fused jax.random's threefry.  Its
    # times are a call of each RNG function on RNG['lanes'][-1] lanes;
    # `launches` counts a bench chunk's (phase rng).
    rows.append({"name": "threefry", "route": "cuda",
                 "source": "bpt_tpu_torch/csrc/threefry.cu",
                 "replaces": None, "launches": r1["launches"],
                 "launches_per_sample": r1["launches_per_sample"],
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
