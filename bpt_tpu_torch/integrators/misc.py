"""Normal, simple, ao and ro integrators (port of
bpt_tpu/integrators/misc.py).

The reference renderer's registry slots for these (src/integrators/
normal.h, simple.h, ao.h:18-24, ro.h) are stubs; the reference package
gives them their intended course semantics, and so does the port:

  * normal: |shading normal|;
  * simple: direct light from the first emitter as a point light
    (Scene::getFirstLightPosition/Intensity, renderer.cpp:341-347);
  * ao: cosine-hemisphere ambient occlusion;
  * ro: reflective occlusion, Phong-lobe sampled with the config's
    exponent (main.cpp:84-87).
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.api import trace_any
from ..core import rng, warp
from ..core.camera import generate_rays
from ..core.math import (
    EPSILON,
    INV_PI,
    frame_n,
    frame_to_local,
    frame_to_world,
    length2,
    make_frame,
    reflect_local,
)
from ..ops.gather import gather_rows
from .common import primary_trace, textured_kd


@dataclasses.dataclass(frozen=True)
class MiscConfig:
    width: int
    height: int
    spp: int
    integrator: str = "normal"  # normal | simple | ao | ro
    exponent: float = 30.0      # ro (main.cpp:86)
    near: float = 1.0
    far: float = 1000.0


def first_light(scene, meta):
    """The first emitter as a point light (reference:
    Scene::getFirstLight*, renderer.cpp:341-363): its shape's center and
    its radiance, or zeros without an emitter shape."""
    dev = scene.emitters.radiance.device
    shape_ids = scene.emitters.shape_id.cpu().numpy()
    if len(shape_ids) and shape_ids[0] >= 0:
        return (torch.as_tensor(meta.shapes_center[int(shape_ids[0])],
                                dtype=torch.float32, device=dev),
                scene.emitters.radiance[0])
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    return zero, zero


def render_sample_misc(scene, first_light_pos, first_light_intensity,
                       cam_consts, cfg: MiscConfig, key, pixel_idx):
    """One sample per pixel lane; returns (framebuffer contribution
    (W*H, 3), ray count 0-dim int64: the primary rays, as the reference
    counts them)."""
    b = pixel_idx.shape[0]
    w, h = cfg.width, cfg.height
    lkeys = rng.lane_keys(key, pixel_idx)
    jitter = None
    if cfg.spp > 1:
        jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    o, d = generate_rays(cam_consts, w, h, pixel_idx, jitter)
    hit, it = primary_trace(scene, o, d, cfg.near, cfg.far)

    if cfg.integrator == "normal":
        li = torch.abs(frame_n(it.frame_ns))
    elif cfg.integrator == "simple":
        to_l = first_light_pos - it.p
        d2 = torch.clamp_min(length2(to_l), 1e-20)
        wi_w = to_l / torch.sqrt(d2)[..., None]
        wi_l = frame_to_local(it.frame_ns, wi_w)
        occ = trace_any(scene, it.p, wi_w, EPSILON, torch.sqrt(d2) - 1e-4)
        kd_ov = textured_kd(scene, it)
        albedo = (gather_rows((scene.mat.diffuse,), it.mat_id)[0]
                  if kd_ov is None else kd_ov)
        li = (albedo * INV_PI * torch.clamp_min(wi_l[..., 2:3], 0.0)
              * first_light_intensity / d2[..., None])
        li = torch.where(occ[..., None], torch.zeros_like(li), li)
    elif cfg.integrator == "ao":
        u2 = rng.uniform2(rng.lane_fold(lkeys, rng.BSDF_SAMPLE))
        wi_w = frame_to_world(it.frame_ns,
                              warp.square_to_cosine_hemisphere(u2))
        occ = trace_any(scene, it.p, wi_w, EPSILON, torch.inf)
        # cos/pi sampling cancels the cos/pi integrand: visibility only.
        li = torch.where(occ, 0.0, 1.0)[..., None].expand(b, 3)
    elif cfg.integrator == "ro":
        u2 = rng.uniform2(rng.lane_fold(lkeys, rng.BSDF_SAMPLE))
        lobe = warp.square_to_phong_lobe(u2, cfg.exponent)
        wi_l = frame_to_world(make_frame(reflect_local(it.wo)), lobe)
        wi_w = frame_to_world(it.frame_ns, wi_l)
        occ = trace_any(scene, it.p, wi_w, EPSILON, torch.inf)
        # (n+2)/(2pi) cos^n / pdf == 1 for the sampled lobe; weight by the
        # clamped surface cosine.
        vis = torch.where(occ, 0.0, 1.0)
        li = (vis * torch.clamp_min(wi_l[..., 2], 0.0))[..., None].expand(
            b, 3)
    else:
        raise ValueError(cfg.integrator)

    li = torch.where(hit.valid[..., None], li, torch.zeros_like(li))
    fb = torch.zeros((w * h, 3), dtype=torch.float32, device=d.device)
    fb.index_add_(0, pixel_idx.long(), li / cfg.spp)
    return fb, torch.full((), b, dtype=torch.int64, device=d.device)


def render_image_misc(scene, meta, camera, cfg: MiscConfig, seed: int = 0):
    """One sample at a time, sample s keyed fold_in(key(seed), s); returns
    the (H, W, 3) image and the total ray count."""
    device = scene.geom.v0.device
    flp, fli = first_light(scene, meta)
    cam_consts = camera.device_constants(device)
    key = rng.key(seed, device)
    w, h = cfg.width, cfg.height
    pixel_idx = torch.arange(w * h, dtype=torch.int32, device=device)
    fb = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    total = 0
    for s in range(cfg.spp):
        fb_c, nr = render_sample_misc(scene, flp, fli, cam_consts, cfg,
                                      rng.fold_in(key, s), pixel_idx)
        fb = fb + fb_c
        total += int(nr)
    return fb.reshape(h, w, 3), total
