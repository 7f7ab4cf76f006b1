"""Realtime mode: a progressive-refinement frame loop (port of
bpt_tpu/realtime.py).

The reference renderer's realtime mode is an SDL/OpenGL rasterizer with
four passes (normal, simple, SSAO, baked GI; src/core/renderpass.cpp)
that saves its FIRST frame to EXR (renderpass.cpp:65-80) and then
redraws in a window.  As in the reference package, a frame here is a
low-spp Monte-Carlo estimate of the same pass, accumulated into a running
image on the scene's device:

  * frame 1 is written to `<scene>.exr` like the reference's first-frame
    save; later frames refresh the same file (one copy to the host a
    frame, for the EXR);
  * the wall time and frames/s of each frame are printed in place of the
    GL swap loop.

  | TOML type | reference pass | integrator here |
  |-----------|----------------|-----------------|
  | normal    | NormalPass     | `normal`        |
  | simple    | SimplePass     | `simple`        |
  | ssao      | SSAOPass       | `ao`            |
  | gi        | GIPass         | `path`, explicit|
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

PASS_TO_INTEGRATOR = {
    "normal": "normal",
    "simple": "simple",
    "ssao": "ao",
    "gi": "path",
}


def _pass_type(cfg_t) -> str:
    pass_type = PASS_TO_INTEGRATOR.get(cfg_t.integrator, cfg_t.integrator)
    if pass_type not in ("normal", "simple", "ao", "path"):
        raise ValueError(
            f"realtime mode supports normal/simple/ssao/gi passes only "
            f"(reference ERenderPass, core.h:47-54); got "
            f"{cfg_t.integrator!r}")
    return pass_type


def _render_frame(scene, meta, cfg_t, seed, spp_per_frame):
    """One frame of the pass: ((H, W, 3) image on the scene's device,
    rays traced)."""
    from .integrators.misc import MiscConfig, render_image_misc
    from .integrators.path import PathConfig, render_image_path

    pass_type = _pass_type(cfg_t)
    if pass_type == "path":
        cfg = PathConfig(
            width=cfg_t.width, height=cfg_t.height, spp=spp_per_frame,
            is_explicit=True, max_depth=cfg_t.max_depth,
            rr_depth=cfg_t.rr_depth, rr_prob=cfg_t.rr_prob)
        return render_image_path(scene, cfg_t.camera, cfg, seed=seed,
                                 spp_chunk=spp_per_frame)
    cfg = MiscConfig(width=cfg_t.width, height=cfg_t.height,
                     spp=spp_per_frame, integrator=pass_type,
                     exponent=cfg_t.exponent)
    return render_image_misc(scene, meta, cfg_t.camera, cfg, seed=seed)


def run_realtime(scene, meta, cfg_t, out_path, seed=0, frames=None,
                 spp_per_frame=1, write_exr=None):
    """Progressive frame loop.  Returns (final image on the scene's
    device, frames rendered, rays traced).

    frames: frame budget (default: ceil(spp / spp_per_frame), so the
    total sample count matches the TOML's spp)."""
    if write_exr is None:
        from .io.exr import write_exr

    _pass_type(cfg_t)
    if frames is None:
        frames = max((cfg_t.spp + spp_per_frame - 1) // spp_per_frame, 1)

    acc = torch.zeros((cfg_t.height, cfg_t.width, 3), dtype=torch.float32,
                      device=scene.geom.v0.device)
    done = 0
    n_rays = 0
    for f in range(frames):
        t0 = time.time()
        img, nr = _render_frame(scene, meta, cfg_t, seed + f, spp_per_frame)
        acc += img
        n_rays += int(nr)
        done += 1
        # First frame saved like the reference (renderpass.cpp:65-80);
        # later frames progressively refresh the same file.
        write_exr(out_path, (acc / done).cpu().numpy())
        dt = time.time() - t0
        print(f"frame {f + 1}/{frames}: {dt * 1e3:.0f} ms "
              f"({1.0 / max(dt, 1e-9):.1f} fps)", flush=True)
    return acc / max(done, 1), done, n_rays


def run_interactive(scene, meta, cfg_t, out_path, commands, seed=0,
                    spp_per_frame=1, write_exr=None):
    """Free-fly interactive frame loop (the reference's WASD camera,
    renderpass.cpp:419-449 + camera.h CameraRT; see core/flycam.py).

    commands: a fly-command string (core.flycam.parse_commands grammar;
    '.' = one frame) or an iterable of (event, value) pairs.  Each frame
    integrates pending camera motion; when the pose changed, progressive
    accumulation RESETS and refinement restarts at the new pose.

    Returns (final image on the scene's device, poses: list of
    (frames_accumulated, camera)).
    """
    from .core.flycam import FlyCamera, parse_commands

    if write_exr is None:
        from .io.exr import write_exr
    if isinstance(commands, str):
        commands = parse_commands(commands)

    fly = FlyCamera.from_lookat(
        o=np.asarray(cfg_t.camera.o), at=np.asarray(cfg_t.camera.at),
        up=np.asarray(cfg_t.camera.up), fov=cfg_t.camera.fov)

    acc = torch.zeros((cfg_t.height, cfg_t.width, 3), dtype=torch.float32,
                      device=scene.geom.v0.device)
    done = 0
    frame_no = 0
    poses = []
    cam = fly.camera(cfg_t.width, cfg_t.height)

    for ev, val in commands:
        if ev == ".":
            if fly.update():          # pose changed -> reset refinement
                poses.append((done, cam))
                cam = fly.camera(cfg_t.width, cfg_t.height)
                acc.zero_()
                done = 0
            t0 = time.time()
            img, _ = _render_frame(scene, meta,
                                   dataclasses.replace(cfg_t, camera=cam),
                                   seed + frame_no, spp_per_frame)
            acc += img
            done += 1
            frame_no += 1
            write_exr(out_path, (acc / done).cpu().numpy())
            dt = time.time() - t0
            print(f"frame {frame_no}: {dt * 1e3:.0f} ms "
                  f"({1.0 / max(dt, 1e-9):.1f} fps)", flush=True)
        elif ev in "wasd":
            fly.move(ev)
        elif ev == "P":
            fly.pitch(val)
        elif ev == "H":
            fly.heading(val)
    poses.append((done, cam))
    return acc / max(done, 1), poses
