"""Where the pooled estimator's dependence on the pool size comes from:
one pool, one estimate, only the MIS weights' light-path count changed.

For each case the pool keeps its size N and its 1/N normalisation; the
weights count c light paths (the eye walk's initial vcm and the t=1
weight, as `pool_size_bias.mis_count` sets them).  Any set of weights
that sums to one over the techniques a path can be made by leaves the
mean where it is, so a mean that moves with c shows weights that do not
sum to one over the techniques the walks make.  Every count runs on the
same keys (6 seeds from 100), so the paired differences carry little of
the noise.  Each sample is split into the eye walk's s=0 and NEE, the
s>=2 connections to the pool and the t=1 splats, and their sum is held
to render_sample_pool's image.

    env PYTHONPATH=. python3 probes/pool_mis_count.py         # on the GPU
    env PYTHONPATH=. python3 probes/pool_mis_count.py --device cpu --quick

One JSON line a case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from bpt_tpu_torch.accel.api import trace_closest
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.core.camera import generate_rays
from bpt_tpu_torch.integrators.bdpt import (
    BDPTConfig,
    connect_pool,
    eye_subpath_walk,
    light_subpath_walk,
    render_sample_pool,
)
from bpt_tpu_torch.scene.procedural import cornell_box_scene
from pool_size_bias import mis_count

SEEDS = range(100, 106)
PARTS = ("eye_s0_nee", "connect", "t1")
# (width, spp, pool size N, walk settings, light-path counts c of the
# weights; the first is the pool's own)
CASES = [(32, 8, 1024, dict(rr_depth=3), (1024, 64, 16384)),
         (32, 8, 1024, dict(rr_depth=16), (1024, 64, 16384)),
         (32, 8, 64, dict(rr_depth=3), (64, 1024))]
QUICK = [(8, 2, 64, dict(rr_depth=3), (64, 4))]


def split_sample(scene, cc, cfg, key, pix, pids):
    """render_sample_pool's steps, its image mean split by technique:
    (3,) float64, in PARTS order."""
    n = cfg.width * cfg.height
    lkeys = rng.lane_keys(key, pix)
    jitter = None
    if cfg.spp > 1:
        jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    o, d = generate_rays(cc, cfg.width, cfg.height, pix, jitter)
    alive = trace_closest(scene, o, d, cfg.near, cfg.far).valid[..., None]
    p = pids.shape[0]
    pkeys = rng.lane_keys(rng.stream(key, rng.POOL_WALK), pids)
    slots, splat_pix, splat_rgb, _ = light_subpath_walk(
        scene, cc, cfg, pkeys, p, torch.ones_like(pids, dtype=torch.bool),
        n_light=float(cfg.light_pool))
    li, _, eye = eye_subpath_walk(scene, cc, cfg, lkeys, d,
                                  n_light=float(cfg.light_pool),
                                  collect=True)
    li_c, _ = connect_pool(scene, cfg, eye, slots, cfg.light_pool)
    on_image = (splat_pix.reshape(-1) < n)[..., None]
    sums = [torch.where(alive, li, 0.0).sum() / cfg.spp,
            torch.where(alive, li_c, 0.0).sum() / cfg.spp,
            torch.where(on_image, splat_rgb.reshape(-1, 3), 0.0).sum()]
    return torch.stack(sums).double() / (3 * n)


def run_case(device, w, spp, n_pool, walk, counts):
    t0 = time.perf_counter()
    scene, _, cam = cornell_box_scene(w, w, device=device)
    cc = cam.device_constants(device)
    cfg = BDPTConfig(w, w, spp=spp, light_pool=n_pool, **walk)
    pix = torch.arange(w * w, dtype=torch.int32, device=device)
    pids = torch.arange(n_pool, dtype=torch.int32, device=device)
    # The split adds up to render_sample_pool's image.
    key0 = rng.fold_in(rng.key(SEEDS[0], device), 0)
    whole = float(render_sample_pool(scene, cc, cfg, key0, pix,
                                     pids)[0].double().mean())
    parts0 = float(split_sample(scene, cc, cfg, key0, pix, pids).sum())
    if abs(parts0 - whole) > 1e-5 * abs(whole):
        raise AssertionError(f"split {parts0} against the sample {whole}")
    per_count = {}
    for c in counts:
        with mis_count(c):
            per_seed = []
            for seed in SEEDS:
                key = rng.key(seed, device)
                per_seed.append(sum(
                    split_sample(scene, cc, cfg, rng.fold_in(key, s), pix,
                                 pids) for s in range(spp)).tolist())
        per_count[c] = per_seed
    base = [sum(p) for p in per_count[counts[0]]]
    out = {}
    for c, per_seed in per_count.items():
        totals = [sum(p) for p in per_seed]
        d = [a - b for a, b in zip(totals, base)]
        se_d = statistics.stdev(d) / len(d) ** 0.5 if c != counts[0] else 0
        out[str(c)] = {
            "parts": {k: statistics.mean(p[i] for p in per_seed)
                      for i, k in enumerate(PARTS)},
            "mean_and_se": (statistics.mean(totals),
                            statistics.stdev(totals) / len(totals) ** 0.5),
            "rel_gap_vs_own_count": statistics.mean(totals)
            / statistics.mean(base) - 1,
            "paired_z": statistics.mean(d) / se_d if se_d else 0.0}
    return {"width": w, "spp": spp, "light_pool": n_pool, **walk,
            "seeds": len(SEEDS), "by_count": out,
            "s": time.perf_counter() - t0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="one tiny case (a rehearsal)")
    args = ap.parse_args()
    device = torch.device(args.device)
    for case in QUICK if args.quick else CASES:
        print(json.dumps({**run_case(device, *case),
                          "device": args.device}), flush=True)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
