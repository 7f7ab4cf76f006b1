"""Command-line renderer: `python -m bpt_tpu_torch.cli <scene.toml>` (port
of bpt_tpu/cli.py).

The reference CLI's semantics (src/main.cpp:160-181): one positional TOML
scene file; the EXR is written next to the TOML with the same stem
(integrator.cpp:26-30); the elapsed wall time is printed
(main.cpp:146-152).  Extras over the reference, as in bpt_tpu/cli.py:
--checkpoint (resume), --preview, --seed, --spp-chunk, --out, and the
bdpt switches --mode, --rr/--no-rr, --samples-per-batch.  --device
(default cuda) picks the device; without a CUDA device the CLI raises
unless it is given `--device cpu`.  A `realtime = true` scene runs the
progressive frame loop of realtime.py (--frames; --fly drives the
free-fly camera with a command script).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to render on "
                           "the CPU")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="bpt_tpu_torch",
        description="bidirectional path tracer on PyTorch and CUDA")
    ap.add_argument("scene", help="scene .toml file")
    ap.add_argument("nogui", nargs="?", default=None,
                    help="accepted for reference-CLI compatibility")
    ap.add_argument("--out", default=None, help="output EXR path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spp-chunk", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file; resume if it exists")
    ap.add_argument("--frames", type=int, default=None,
                    help="frame budget for realtime=true scenes")
    ap.add_argument("--fly", default=None, metavar="CMDS",
                    help="free-fly camera command script for realtime "
                         "scenes, e.g. 'ww.P+5;..a.' (core/flycam.py)")
    ap.add_argument("--preview", action="store_true",
                    help="write the EXR after every spp chunk (progressive "
                         "preview)")
    ap.add_argument("--mode", default=None,
                    choices=["bdpt", "light_trace", "path_trace"],
                    help="bdpt ablation (reference LIGHT_TRACING/"
                         "PATH_TRACING switches, bdpt.h:16-17); overrides "
                         "the TOML bdptMode key")
    rr_group = ap.add_mutually_exclusive_group()
    rr_group.add_argument("--rr", dest="no_rr", action="store_false",
                          default=None,
                          help="enable Russian roulette (reference NO_RR=0,"
                               " bdpt.h:18); overrides the TOML noRR key")
    rr_group.add_argument("--no-rr", dest="no_rr", action="store_true",
                          help="rrDepth acts as a hard depth bound "
                               "(reference default NO_RR=1)")
    ap.add_argument("--samples-per-batch", type=int, default=None,
                    help="samples fused per wavefront batch (must divide "
                         "the spp chunk); overrides the TOML "
                         "samplesPerBatch key")
    args = ap.parse_args(argv)
    device = _device(args.device)

    from .core import rng
    from .integrators.bdpt import BDPTConfig, render_chunk
    from .integrators.direct import DirectConfig, render_image_direct
    from .integrators.misc import MiscConfig, render_image_misc
    from .integrators.path import PathConfig, render_image_path
    from .io import checkpoint as ck_io
    from .io.exr import write_exr
    from .scene.scene import load_scene
    from .scene.toml_config import load_toml

    cfg_t = load_toml(args.scene)

    t_load = time.time()
    scene, meta = load_scene(cfg_t.obj_file, device)
    print(f"Found {meta.n_shapes} shapes, {meta.n_triangles} triangles, "
          f"{meta.n_emitters} emitters; BVH {meta.bvh_nodes} nodes "
          f"({time.time() - t_load:.2f}s)")

    out_path = args.out or os.path.splitext(args.scene)[0] + ".exr"

    if cfg_t.realtime:
        # The progressive-refinement frame loop in place of the
        # reference's SDL/GL loop (see realtime.py for the pass mapping).
        from .realtime import run_interactive, run_realtime

        t0 = time.time()
        try:
            if args.fly is not None:
                _, poses = run_interactive(
                    scene, meta, cfg_t, out_path, commands=args.fly,
                    seed=args.seed)
                frames = sum(n for n, _ in poses)
                n_rays = 0
            else:
                _, frames, n_rays = run_realtime(
                    scene, meta, cfg_t, out_path, seed=args.seed,
                    frames=args.frames)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        wall = time.time() - t0
        print(f"Render took: {wall:.2f} seconds ({frames} frames).")
        print(f"Saved EXR image to {out_path}")
        _write_meta(out_path, args, cfg_t, wall, n_rays, device,
                    extra={"realtime": True, "frames": frames})
        return 0

    t0 = time.time()
    n_rays = 0
    if cfg_t.integrator == "bdpt":
        mode = args.mode if args.mode is not None else cfg_t.bdpt_mode
        no_rr = args.no_rr if args.no_rr is not None else cfg_t.no_rr
        spb = (args.samples_per_batch if args.samples_per_batch is not None
               else cfg_t.samples_per_batch)
        cfg = BDPTConfig(width=cfg_t.width, height=cfg_t.height,
                         spp=cfg_t.spp, rr_depth=cfg_t.rr_depth, mode=mode,
                         no_rr=no_rr)
        cam_consts = cfg_t.camera.device_constants(device)
        key = rng.key(args.seed, device)
        fb = np.zeros((cfg.width * cfg.height, 3), np.float32)
        done = 0
        cfg_hash = ck_io.config_hash(
            scene=os.path.abspath(cfg_t.obj_file), integrator="bdpt",
            width=cfg.width, height=cfg.height, spp=cfg.spp,
            rr_depth=cfg.rr_depth, rr_prob=cfg_t.rr_prob, seed=args.seed,
            mode=mode, no_rr=no_rr)
        if args.checkpoint:
            ck = ck_io.load_checkpoint(args.checkpoint)
            if ck is not None:
                ck_io.check_resume(ck, args.seed, cfg_hash)
                fb, done = ck.fb, ck.spp_done
                print(f"resumed at {done}/{cfg.spp} spp")
        while done < cfg.spp:
            n = min(args.spp_chunk, cfg.spp - done)
            fb_c, nr = render_chunk(
                scene, cam_consts, cfg, key, n, sample_offset=done,
                samples_per_batch=spb if n % spb == 0 else 1)
            fb = fb + fb_c.cpu().numpy()
            n_rays += int(nr)
            done += n
            if args.checkpoint:
                ck_io.save_checkpoint(args.checkpoint, fb, args.seed, done,
                                      cfg.spp, cfg_hash)
            if args.preview and done < cfg.spp:
                # The partial estimate scaled to the samples taken so far.
                write_exr(out_path, (fb * (cfg.spp / done)).reshape(
                    cfg.height, cfg.width, 3))
            print(f"\r{done}/{cfg.spp} spp", end="", flush=True)
        print()
        img = fb.reshape(cfg.height, cfg.width, 3)
    elif cfg_t.integrator == "path":
        cfg = PathConfig(
            width=cfg_t.width, height=cfg_t.height, spp=cfg_t.spp,
            is_explicit=cfg_t.is_explicit, max_depth=cfg_t.max_depth,
            rr_depth=cfg_t.rr_depth, rr_prob=cfg_t.rr_prob,
            emitter_samples=cfg_t.emitter_samples,
            bsdf_samples=cfg_t.bsdf_samples)
        img, n_rays = render_image_path(scene, cfg_t.camera, cfg,
                                        seed=args.seed,
                                        spp_chunk=args.spp_chunk)
    elif cfg_t.integrator == "direct":
        cfg = DirectConfig(
            width=cfg_t.width, height=cfg_t.height, spp=cfg_t.spp,
            strategy=cfg_t.sampling_strategy,
            emitter_samples=cfg_t.emitter_samples,
            bsdf_samples=cfg_t.bsdf_samples)
        img, n_rays = render_image_direct(scene, meta, cfg_t.camera, cfg,
                                          seed=args.seed)
    elif cfg_t.integrator in ("normal", "simple", "ao", "ro"):
        cfg = MiscConfig(width=cfg_t.width, height=cfg_t.height,
                         spp=cfg_t.spp, integrator=cfg_t.integrator,
                         exponent=cfg_t.exponent)
        img, n_rays = render_image_misc(scene, meta, cfg_t.camera, cfg,
                                        seed=args.seed)
    else:
        print(f"Invalid integrator type: {cfg_t.integrator}",
              file=sys.stderr)
        return 1
    if torch.is_tensor(img):
        img = img.cpu().numpy()

    wall = time.time() - t0
    print(f"Render took: {wall:.2f} seconds.")
    write_exr(out_path, img)
    print(f"Saved EXR image to {out_path}")

    extra = {}
    if cfg_t.integrator == "bdpt":
        extra = {"mode": cfg.mode, "no_rr": cfg.no_rr,
                 "rr_depth": cfg.rr_depth}
    _write_meta(out_path, args, cfg_t, wall, n_rays, device, extra=extra)
    return 0


def _write_meta(out_path, args, cfg_t, wall, n_rays, device, extra=None):
    """Structured metadata beside the EXR, with the device that rendered
    it."""
    import json

    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
    else:
        name, count = str(device), 1
    meta_out = {
        "scene": os.path.abspath(args.scene),
        "integrator": cfg_t.integrator,
        "width": cfg_t.width, "height": cfg_t.height, "spp": cfg_t.spp,
        "seed": args.seed,
        "wall_s": round(wall, 3),
        "rays": n_rays,
        "rays_per_sec": round(n_rays / max(wall, 1e-9), 1) if n_rays else None,
        "device": name,
        "n_devices": count,
    }
    meta_out.update(extra or {})
    with open(out_path + ".meta.json", "w") as f:
        json.dump(meta_out, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
