"""Pooled against per-pixel BDPT image means as the pool size and the
walk depth change, on the all-diffuse Cornell box.

For each case, the image mean of `render_sample_pool` (a pool of N light
subpaths a sample, the whole pool in one pass) and of `render_chunk`
(one light subpath a pixel) over 6 seeds from 100, each mean with its
standard error, their relative gap and |z|.  A gap that shrinks as N
approaches W*H and does not shrink with deeper walks is a property of
the pooled estimator, not a truncation of the walks.  Cases marked
`mis_count_w_h` render the pool of N paths with the MIS weights' light
path count set to W*H (the eye walk's initial vcm and the t=1 weight;
the t=1 splats keep their 1/N): a partition of unity as valid as N's,
so the gap it leaves shows how much of the N-dependence the weights
carry.

    python3 probes/pool_size_bias.py                # on the GPU
    python3 probes/pool_size_bias.py --device cpu --quick

One JSON line a case, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from contextlib import nullcontext
from unittest import mock

import torch

from bpt_tpu_torch.core import rng
from bpt_tpu_torch.integrators import mis
from bpt_tpu_torch.integrators.bdpt import (
    BDPTConfig,
    render_chunk,
    render_sample_pool,
)
from bpt_tpu_torch.scene.procedural import cornell_box_scene

SEEDS = range(100, 106)
# (width, spp, pool size, walk settings, MIS light-path count W*H)
CASES = [(32, 8, 16, dict(rr_depth=3), False),
         (32, 8, 64, dict(rr_depth=3), False),
         (32, 8, 1024, dict(rr_depth=3), False),
         (32, 8, 64, dict(rr_depth=16), False),
         (32, 8, 64, dict(rr_depth=3, no_rr=False, max_bounces=16), False),
         (64, 8, 64, dict(rr_depth=3), False),
         (32, 8, 16, dict(rr_depth=3), True),
         (32, 8, 64, dict(rr_depth=3), True),
         (32, 8, 64, dict(rr_depth=16), True)]
QUICK = [(8, 2, 4, dict(rr_depth=3), False),
         (8, 2, 4, dict(rr_depth=3), True)]


def mis_count(n):
    """The MIS functions with their light-path count replaced by n."""
    init, t1 = mis.eye_walk_init, mis.weight_t1
    return mock.patch.multiple(
        mis, eye_walk_init=lambda _, t1_pdf: init(float(n), t1_pdf),
        weight_t1=lambda a, _, p, vc, vcm: t1(a, float(n), p, vc, vcm))


def pooled_mean(scene, cc, cfg, key):
    dev = key.device
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int32, device=dev)
    pids = torch.arange(cfg.light_pool, dtype=torch.int32, device=dev)
    fb = sum(render_sample_pool(scene, cc, cfg, rng.fold_in(key, s), pix,
                                pids)[0] for s in range(cfg.spp))
    return float(fb.double().mean())


def per_pixel_mean(scene, cc, cfg, key):
    fb, _ = render_chunk(scene, cc, cfg, key, cfg.spp,
                         samples_per_batch=cfg.spp)
    return float(fb.double().mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="two tiny cases (a rehearsal)")
    args = ap.parse_args()
    device = torch.device(args.device)
    for w, spp, n_pool, walk, w_h in QUICK if args.quick else CASES:
        t0 = time.perf_counter()
        scene, _, cam = cornell_box_scene(w, w, device=device)
        cc = cam.device_constants(device)
        stats = {}
        for name, cfg, mean in (
                ("pool", BDPTConfig(w, w, spp=spp, light_pool=n_pool,
                                    **walk), pooled_mean),
                ("per_pixel", BDPTConfig(w, w, spp=spp, **walk),
                 per_pixel_mean)):
            with mis_count(w * w) if w_h and name == "pool" else \
                    nullcontext():
                m = [mean(scene, cc, cfg, rng.key(seed, device))
                     for seed in SEEDS]
            stats[name] = (statistics.mean(m),
                           statistics.stdev(m) / len(m) ** 0.5)
        (mp, sp), (mq, sq) = stats["pool"], stats["per_pixel"]
        print(json.dumps({"width": w, "spp": spp, "light_pool": n_pool,
                          **walk, "mis_count_w_h": w_h, "mean_and_se": stats,
                          "rel_gap": mp / mq - 1,
                          "z": abs(mp - mq) / (sp ** 2 + sq ** 2) ** 0.5,
                          "device": args.device,
                          "s": time.perf_counter() - t0}), flush=True)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
