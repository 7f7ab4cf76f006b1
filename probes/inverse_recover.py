"""BASELINE config #5 on one GPU: recover the BSDF albedo and the light
emission of the glass Cornell box by pixel-gradient descent at 1024x1024
(the port's single-device counterpart of benchmarks/inverse_hires.py
--recover, whose settings it takes: sphere_subdiv 1, spp 2, rr_depth 2,
lr 0.2, 150 iterations, target key 123, iteration keys fold_in(7, it),
held-out key 321 for the PSNR).

The start point: albedo 0.5 on every material that is neither mirror nor
glass (delta BSDFs never read Kd, so theirs carries no gradient and
stays out of the error), emission x0.3.  Each iteration is one
`diff/inverse.py::recover_materials` step (forward render of the full
spp, loss against the target, autograd backward, the Adam-style update).
Reported as one JSON object: the loss trajectory, the median step time
(steps after the first), the peak device memory of the recovery, the
mean and max relative error of the recovered diffuse (recoverable
materials) and emission (emissive materials), the PSNR of the start
point's and of the recovered render against the target, and the card's
`nvidia-smi` name and power limit.  Any non-finite gradient or a loss
that does not fall raises.

    env PYTHONPATH=. python3 probes/inverse_recover.py [--res 1024]
        [--iters 150] [--device cuda] [--profile]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from bpt_tpu_torch.bsdf import bsdf as bsdf_mod
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.diff import grad as dgrad
from bpt_tpu_torch.diff import inverse
from bpt_tpu_torch.integrators.bdpt import BDPTConfig
from bpt_tpu_torch.scene.procedural import cornell_box_scene

FIELDS = ("diffuse", "emission")
TARGET_KEY, TRAIN_SEED, HELD_OUT_KEY = 123, 7, 321


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rel_err(rec, true, mask):
    rec, true = rec.cpu().numpy()[mask], true.cpu().numpy()[mask]
    e = np.abs(rec - true) / np.maximum(np.abs(true), 0.05)
    return float(e.mean()), float(e.max())


def _psnr(img, target):
    mse = float(torch.mean((img - target) ** 2))
    peak = max(float(target.max()), 1e-9)
    return 10.0 * np.log10(peak ** 2 / max(mse, 1e-12))


def run(res=1024, iters=150, spp=2, lr=0.2, device="cuda", profile=None):
    """The recovery at res x res; returns the report (a dict).

    profile: optional fn(step, step_wall_s) -> dict, called after the
    recovery with one more step (loss_and_grad at the recovered
    parameters); its result goes into the report as "profile"."""
    device = torch.device(device)
    w = h = res
    scene, _, cam = cornell_box_scene(w, h, device=device,
                                      right_object="glass_sphere",
                                      sphere_subdiv=1)
    cfg = BDPTConfig(w, h, spp=spp, rr_depth=2)
    cc = cam.device_constants(device)
    true_params = dgrad.extract_params(scene)

    def render(params, seed):
        with torch.no_grad():
            return dgrad.render_with_params(params, scene, cc, cfg,
                                            rng.key(seed, device), cfg.spp)

    t0 = time.perf_counter()
    target = render(true_params, TARGET_KEY)
    _sync(device)
    target_s = time.perf_counter() - t0

    kind = scene.mat.kind.cpu().numpy()
    recoverable = ~((kind == bsdf_mod.MIRROR) | (kind == bsdf_mod.GLASS))
    emissive = true_params["emission"].cpu().numpy().max(axis=-1) > 0.0
    rec_mask = torch.as_tensor(recoverable, device=device)[:, None]
    start = {"diffuse": torch.where(rec_mask, torch.full_like(
                 true_params["diffuse"], 0.5), true_params["diffuse"]),
             "emission": true_params["emission"] * 0.3}

    grads_finite = []

    def checked(*args):
        loss, g = dgrad.loss_and_grad(*args)
        grads_finite.append(all(bool(torch.isfinite(v).all())
                                for v in g.values()))
        return loss, g

    stamps = []

    def stamp(it, loss, params):
        _sync(device)
        stamps.append(time.perf_counter())

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    with mock.patch.object(inverse, "loss_and_grad", checked):
        result = inverse.recover_materials(
            scene, cam, cfg, target, fields=FIELDS, init_params=start,
            iterations=iters, lr=lr, spp_chunk=cfg.spp, seed=TRAIN_SEED,
            callback=stamp)
    steps = np.diff([t0] + stamps).tolist()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    losses = result.losses
    bad = [i for i, ok in enumerate(grads_finite) if not ok]
    if bad:
        raise AssertionError(f"non-finite gradients at iterations {bad}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")

    params = result.params
    step_median = statistics.median(steps[1:] or steps)
    profiled = None
    if profile is not None:
        key = rng.fold_in(rng.key(TRAIN_SEED, device), iters)
        profiled = profile(lambda: dgrad.loss_and_grad(
            params, scene, cc, cfg, key, cfg.spp, target), step_median)
    kd_mean, kd_max = _rel_err(params["diffuse"], true_params["diffuse"],
                               recoverable)
    ke_mean, ke_max = _rel_err(params["emission"], true_params["emission"],
                               emissive)
    return {
        "which": "BASELINE config #5 on one device (inverse_hires.py "
                 "--recover's settings)",
        "resolution": f"{w}x{h}", "device": str(device),
        "card": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "nvidia_smi": _nvidia_smi() if device.type == "cuda" else None,
        "spp": cfg.spp, "rr_depth": cfg.rr_depth, "lr": lr, "iters": iters,
        "target_render_s": target_s,
        "losses": losses,
        "loss_decreased": True,
        "step_s": steps,
        "step_s_median": step_median,
        "peak_mem_bytes": peak,
        "profile": profiled,
        "recovery": {
            "diffuse_rel_err_mean": kd_mean, "diffuse_rel_err_max": kd_max,
            "emission_rel_err_mean": ke_mean,
            "emission_rel_err_max": ke_max,
            "psnr_start_db": _psnr(render(start, HELD_OUT_KEY), target),
            "psnr_recovered_db": _psnr(render(params, HELD_OUT_KEY), target),
            "recoverable_materials": int(recoverable.sum()),
            "emissive_materials": int(emissive.sum()),
            "goal_mean_err_below_5pct": bool(max(kd_mean, ke_mean) < 0.05),
        },
    }


def _profile(step, step_wall_s):
    """Device time of one call of `step` (torch.profiler, read by
    portbench/harness/trace.py): busy seconds, the idle share against
    `step_wall_s`, the unprofiled step's wall (the profiler slows the
    host), and the ops that took most device time."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import trace

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tr = trace.summarize(trace.events(prof), wall)
    if tr.busy_s == 0.0:
        return {"profile": "not measured (no device time in the trace)"}
    return {"device_busy_s": tr.busy_s, "step_wall_s": step_wall_s,
            "device_idle_share": max(0.0, 1.0 - tr.busy_s / step_wall_s),
            "profile_wall_s": wall, "kernels": tr.kernels,
            "device_ops_s": tr.device_ops}


def _nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more step after the recovery "
                         "(device busy time, idle share, the ops that "
                         "took most device time)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("inverse_recover: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 2
    print(json.dumps(run(args.res, args.iters, args.spp, args.lr,
                         args.device, _profile if args.profile else None)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
