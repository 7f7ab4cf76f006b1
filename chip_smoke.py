"""Bring-up check of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from bpt_tpu_torch/csrc/, checks each one
against its plain PyTorch version at the main path's shapes, renders the
bench configuration (procedural glass Cornell box, 256x256, 16 spp,
rr_depth 8, 2 samples per batch, seed 7) through the kernels, and
compares a small render through the kernels with one through the plain
versions.  One JSON line per phase; the second-to-last lines are the
card's `nvidia-smi` name and power limit and the per-kernel summary; the
last line is {"ok": true, "device": {...}}.  Any failed check raises, so
the exit code is not 0 and no result line is printed.  Without a CUDA
device it exits with code 2.  JAX is never imported.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

SEED = 7
BENCH = dict(width=256, height=256, spp=16, rr_depth=8, sb=2)
SMALL = dict(width=64, height=64, spp=4, rr_depth=5)
DEAD_FRAC_K1 = 0.10
LIVE_FRAC_K2 = 0.30
REPS = 5


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS):
    """Mean device time of fn() in ms over `reps` calls, CUDA events,
    after one warm-up call."""
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


def bench_scene(device):
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    return cornell_box_scene(BENCH["width"], BENCH["height"], device=device,
                             right_object="glass_sphere", sphere_subdiv=3)


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
    starts, light-side ends), ~70% dead, as in the mega-connect batch."""
    from bpt_tpu_torch.ops.trace_closest import closest_hit

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    m = 1 << 18
    lo = torch.tensor([-0.99, 0.01, -0.99], device=device)
    hi = torch.tensor([0.99, 1.99, 0.99], device=device)
    pts = []
    for _ in range(2):
        o = lo + (hi - lo) * _uniform(gen, (m, 3), device)
        d = _random_dirs(gen, m, device)
        t, tri, _, _ = closest_hit(scene.treelets, o, d,
                                   torch.full((m,), 1e-8, device=device),
                                   torch.full((m,), float("inf"),
                                              device=device))
        keep = tri >= 0
        pts.append((o + d * t[:, None])[keep])
    ia = torch.randint(0, pts[0].shape[0], (n,), generator=gen, device=device)
    ib = torch.randint(0, pts[1].shape[0], (n,), generator=gen, device=device)
    start, end = pts[0][ia], pts[1][ib]
    seg = end - start
    dist = torch.linalg.vector_norm(seg, dim=-1)
    d = seg / torch.clamp_min(dist, 1e-20)[:, None]
    live = _uniform(gen, n, device) < LIVE_FRAC_K2
    max_t = torch.where(live, dist - 1e-5, torch.full_like(dist, -1.0))
    return start, d, torch.full((n,), 1e-8, device=device), max_t


def phase_device():
    from bpt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    info = {
        "phase": "device",
        "nvidia_smi": nvidia_smi_line(),
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "kernel_build_s": time.perf_counter() - t0,
        "ptxas": ptxas,
    }
    emit(info)
    return info


def phase_k1(scene, cam, device):
    from bpt_tpu_torch.ops.compaction import compact_rays
    from bpt_tpu_torch.accel.api import scene_bounds
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_plain

    tg = scene.treelets
    out = {"phase": "k1_closest_hit"}
    timing = None
    for name, rays in zip(("primary", "walk"), k1_inputs(scene, cam, device)):
        o, d, mn, mx, _ = compact_rays(*rays, bounds=scene_bounds(tg),
                                       kind="ray")
        o, d = o.contiguous(), d.contiguous()
        got = closest_hit(tg, o, d, mn, mx)
        ref = closest_hit_plain(tg, o, d, mn, mx)
        torch.cuda.synchronize()
        n = o.shape[0]
        tri_bad = int((got[1] != ref[1]).sum())
        bits_bad = [int((g.view(torch.int32) != r.view(torch.int32)).sum())
                    for g, r in ((got[0], ref[0]), (got[2], ref[2]),
                                 (got[3], ref[3]))]
        hit = ref[1] >= 0
        err = max(float((got[i][hit] - ref[i][hit]).abs().max())
                  if bool(hit.any()) else 0.0 for i in (0, 2, 3))
        k_ms = cuda_ms(lambda: closest_hit(tg, o, d, mn, mx))
        p_ms = cuda_ms(lambda: closest_hit_plain(tg, o, d, mn, mx), reps=2)
        cmp_ms = cuda_ms(lambda: compact_rays(*rays, bounds=scene_bounds(tg),
                                              kind="ray"))
        raw = [x.contiguous() for x in rays]
        raw_ms = cuda_ms(lambda: closest_hit(tg, *raw))
        out[name] = {"lanes": n, "live": int((mx >= mn).sum()),
                     "hits": int(hit.sum()), "tri_mismatch": tri_bad,
                     "t_u_v_bit_mismatch": bits_bad, "max_abs_err": err,
                     "ms": k_ms, "plain_ms": p_ms, "compact_ms": cmp_ms,
                     "ms_uncompacted": raw_ms}
        if tri_bad or any(bits_bad):
            emit(out)
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"the {name} batch")
        if name == "walk":
            timing = (k_ms, p_ms, err)
    emit(out)
    return timing


def phase_k2(scene, device, n):
    from bpt_tpu_torch.accel.api import scene_bounds
    from bpt_tpu_torch.ops.compaction import compact_rays
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_plain

    tg = scene.treelets_any
    segs = k2_inputs(scene, device, n)
    o, d, mn, mx, _ = compact_rays(*segs, bounds=scene_bounds(tg))
    o, d = o.contiguous(), d.contiguous()
    got = any_hit(tg, o, d, mn, mx)
    ref = any_hit_plain(tg, o, d, mn, mx)
    torch.cuda.synchronize()
    bad = int((got != ref).sum())
    # The flags as 0/1 integers: max |kernel - plain| is 0 or 1.
    flag_err = float((got.int() - ref.int()).abs().max())
    k_ms = cuda_ms(lambda: any_hit(tg, o, d, mn, mx))
    p_ms = cuda_ms(lambda: any_hit_plain(tg, o, d, mn, mx), reps=2)
    cmp_ms = cuda_ms(lambda: compact_rays(*segs, bounds=scene_bounds(tg)))
    raw_ms = cuda_ms(lambda: any_hit(tg, *segs))
    out = {"phase": "k2_any_hit", "lanes": n,
           "live": int((mx >= mn).sum()), "occluded": int(ref.sum()),
           "flag_mismatch": bad, "ms": k_ms, "plain_ms": p_ms,
           "compact_ms": cmp_ms, "ms_uncompacted": raw_ms}
    emit(out)
    if bad:
        raise AssertionError("K2 disagrees with its plain version")
    return k_ms, p_ms, flag_err, bad


def _profile_batch(scene, cam_consts, cfg, key, batch_wall_s):
    """Device time by kernel over one sample batch (torch.profiler).  The
    idle share is taken against `batch_wall_s`, the unprofiled wall of
    one batch, because the profiler itself slows the host down; the
    share against the profiled batch's wall is printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    from bpt_tpu_torch.integrators.bdpt import render_chunk

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_chunk(scene, cam_consts, cfg, key, BENCH["sb"],
                     samples_per_batch=BENCH["sb"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"k1_closest_hit": 0.0, "k2_any_hit": 0.0, "sort": 0.0,
              "other": 0.0}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key
        if "closest_hit_kernel" in name:
            groups["k1_closest_hit"] += us
        elif "any_hit_kernel" in name:
            groups["k2_any_hit"] += us
        elif "sort" in name.lower() or "radix" in name.lower():
            groups["sort"] += us
        else:
            groups["other"] += us
    total = sum(groups.values())
    if total == 0.0:
        return {"profile": "not measured (no device time in the trace)"}
    busy = total / 1e6
    return {"device_busy_s": busy, "batch_wall_s": batch_wall_s,
            "device_idle_share": max(0.0, 1.0 - busy / batch_wall_s),
            "profile_wall_s": wall,
            "device_idle_share_profiled": max(0.0, 1.0 - busy / wall),
            "device_s_by_group": {k: v / 1e6 for k, v in groups.items()}}


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


def phase_slice(scene, cam, device, smi):
    from unittest import mock

    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_chunk
    from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_plain
    from bpt_tpu_torch.ops.trace_closest import closest_hit, \
        closest_hit_plain

    cfg = BDPTConfig(BENCH["width"], BENCH["height"], spp=BENCH["spp"],
                     rr_depth=BENCH["rr_depth"])
    cam_consts = cam.device_constants(device)
    key = rng.key(SEED, device)

    def chunk():
        fb, nr = render_chunk(scene, cam_consts, cfg, key, cfg.spp,
                              samples_per_batch=BENCH["sb"])
        torch.cuda.synchronize()
        return fb, int(nr)

    t0 = time.perf_counter()
    chunk()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    closest_hit.launches = any_hit.launches = 0
    closest_hit_plain.cuda_calls = any_hit_plain.cuda_calls = 0
    t0 = time.perf_counter()
    fb, nrays = chunk()
    wall = time.perf_counter() - t0
    launches = {"k1_closest_hit": closest_hit.launches,
                "k2_any_hit": any_hit.launches}
    plain_calls = closest_hit_plain.cuda_calls + any_hit_plain.cuda_calls
    peak = torch.cuda.max_memory_allocated()

    # Spread, and compaction's share: more chunks, alternating with chunks
    # where compaction is swapped for the identity layout (a measurement
    # harness; results are unchanged because dead lanes miss in the
    # kernels either way).
    walls, walls_nc = [wall], []
    for swapped in (True, True, False, False, True):
        if swapped:
            with mock.patch.object(api, "compact_rays", _identity_layout):
                t0 = time.perf_counter()
                fb_nc, nrays_nc = chunk()
                walls_nc.append(time.perf_counter() - t0)
        else:
            t0 = time.perf_counter()
            chunk()
            walls.append(time.perf_counter() - t0)
    wall_med = statistics.median(walls)
    wall_nc_med = statistics.median(walls_nc)

    out = {"phase": "slice", "config": "procedural glass cbox 256x256 "
           "16spp rr8 sb2 seed7", "nvidia_smi": smi, "warmup_s": warm_s,
           "wall_s": wall_med, "wall_s_runs": walls, "nrays": nrays,
           "rays_per_s": nrays / wall_med,
           "peak_mem_bytes": peak, "launches": launches,
           "plain_calls_on_cuda": plain_calls,
           "image_mean": float(fb.mean()),
           "finite": bool(torch.isfinite(fb).all()),
           "wall_s_without_compaction": wall_nc_med,
           "wall_s_without_compaction_runs": walls_nc,
           "nrays_without_compaction": nrays_nc,
           "image_mean_without_compaction": float(fb_nc.mean())}
    batches = cfg.spp // BENCH["sb"]
    out.update(_profile_batch(scene, cam_consts, cfg, key,
                              wall_med / batches))
    emit(out)
    if not out["finite"]:
        raise AssertionError("non-finite pixels in the slice render")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if plain_calls:
        raise AssertionError("plain versions ran on CUDA tensors")
    if out["image_mean"] <= 0.0:
        raise AssertionError("black image")
    return launches


def phase_paths(device):
    """64x64 4spp rr5 through the kernels and through the plain versions
    (swapped in for this comparison only), gated on aggregates."""
    from unittest import mock

    from bpt_tpu_torch.accel import api
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu_torch.ops.trace_any import any_hit_plain
    from bpt_tpu_torch.ops.trace_closest import closest_hit_plain
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    w = SMALL["width"]
    scene, _, cam = cornell_box_scene(w, w, device=device,
                                      right_object="glass_sphere",
                                      sphere_subdiv=3)
    cfg = BDPTConfig(w, w, spp=SMALL["spp"], rr_depth=SMALL["rr_depth"])
    a, na = render_image(scene, cam, cfg, seed=SEED)
    with mock.patch.object(api, "closest_hit", closest_hit_plain), \
            mock.patch.object(api, "any_hit", any_hit_plain):
        b, nb = render_image(scene, cam, cfg, seed=SEED)
    a, b = a.double(), b.double()
    denom = torch.clamp_min(b.abs(), 1e-3)
    frac_off = float(((a - b).abs() / denom > 1e-3).double().mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(float(b.mean()),
                                                           1e-9)
    nr_rel = abs(na - nb) / max(nb, 1)
    out = {"phase": "kernel_vs_plain_render", "config": "64x64 4spp rr5",
           "pixels_off_frac": frac_off, "mean_rel": mean_rel,
           "nrays": [na, nb], "nrays_rel": nr_rel,
           "finite": bool(torch.isfinite(a).all())}
    emit(out)
    if not (frac_off <= 0.02 and mean_rel <= 1e-3 and nr_rel <= 1e-3
            and out["finite"]):
        raise AssertionError("kernel path and plain path disagree")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import bpt_tpu_torch  # noqa: F401  (sets the TF32 switches)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    info = phase_device()
    scene, _, cam = bench_scene(device)
    k1 = phase_k1(scene, cam, device)
    l = BENCH["rr_depth"] - 1
    k2 = phase_k2(scene, device,
                  l * (l + 2) * BENCH["width"] * BENCH["height"] * BENCH["sb"])
    torch.cuda.empty_cache()
    launches = phase_slice(scene, cam, device, info["nvidia_smi"])
    phase_paths(device)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": [
        {"name": "closest_hit", "route": "cuda",
         "source": "bpt_tpu_torch/csrc/closest_hit.cu",
         "replaces": "bpt_tpu/ops/pallas_trace.py:296",
         "launches": launches["k1_closest_hit"], "max_abs_err": k1[2],
         "ms": k1[0], "plain_ms": k1[1]},
        {"name": "any_hit", "route": "cuda",
         "source": "bpt_tpu_torch/csrc/any_hit.cu",
         "replaces": "bpt_tpu/ops/pallas_sweep.py:216",
         "launches": launches["k2_any_hit"], "max_abs_err": k2[2],
         "flag_mismatch": k2[3], "ms": k2[0], "plain_ms": k2[1]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
