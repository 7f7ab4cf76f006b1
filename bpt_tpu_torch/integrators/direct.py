"""Direct-illumination integrator with five strategies: area, solidAngle,
cosineHemisphere, bsdf and mis (port of bpt_tpu/integrators/direct.py).

The reference DirectIntegrator (src/integrators/direct.h) samples
emitters through a bounding sphere (center from the shape's vertex mean,
radius from its AABB extent, renderer.cpp:349-358), uniformly by area
(direct.h:96-109) or by the cone it subtends (direct.h:111-141), with an
analytic ray-sphere test as the visibility fallback (direct.h:37-69,
304-330).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.api import trace_closest
from ..bsdf import bsdf
from ..core import rng, warp
from ..core.camera import generate_rays
from ..core.math import (
    EPSILON,
    INV_TWOPI,
    PI,
    dot,
    frame_to_local,
    frame_to_world,
    is_zero_rgb,
    length2,
    make_frame,
    normalize,
)
from ..ops.gather import gather_rows
from .common import (emission_at, make_interaction, primary_trace,
                     textured_kd)
from .path import balance_heuristic


@dataclasses.dataclass(frozen=True)
class DirectConfig:
    width: int
    height: int
    spp: int
    strategy: str = "mis"  # mis|area|solidAngle|cosineHemisphere|bsdf
    emitter_samples: int = 1
    bsdf_samples: int = 1
    near: float = 1.0
    far: float = 1000.0


class SphereLights:
    """Bounding-sphere approximations of the emitters, computed on the
    host (reference: Scene::getShapeCenter/getShapeRadius,
    renderer.cpp:349-358: radius = aabb.max.x - center.x)."""

    def __init__(self, scene, meta):
        e = int(scene.emitters.radiance.shape[0])
        centers = np.zeros((e, 3), np.float32)
        radii = np.ones(e, np.float32)
        shape_ids = scene.emitters.shape_id.cpu().numpy()
        for i in range(e):
            sid = int(shape_ids[i])
            if sid >= 0:
                centers[i] = meta.shapes_center[sid]
                radii[i] = (meta.shapes_aabb_max[sid][0]
                            - meta.shapes_center[sid][0])
        dev = scene.emitters.radiance.device
        self.center = torch.from_numpy(centers).to(dev)
        self.radius = torch.from_numpy(radii).to(dev)


def _ray_sphere_hit(o, d, center, radius, min_t, max_t):
    """Analytic sphere test (reference: direct.h:37-69)."""
    no = o - center
    c = dot(no, no) - radius * radius
    b = 2.0 * dot(no, d)
    a = dot(d, d)
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv2a = 1.0 / (2.0 * a)
    r1 = (-b + sq) * inv2a
    r2 = (-b - sq) * inv2a
    inf = torch.full_like(r1, torch.inf)
    r1 = torch.where((r1 > min_t) & (r1 < max_t) & (r1 >= 0), r1, inf)
    r2 = torch.where((r2 > min_t) & (r2 < max_t) & (r2 >= 0), r2, inf)
    t = torch.minimum(r1, r2)
    return ok & (t > min_t) & (t < max_t)


def _select_emitter_sphere(scene, lights, u):
    n = scene.emitters.radiance.shape[0]
    em_id = torch.clamp_max((u * n).to(torch.int32), n - 1)
    em = em_id.long()
    return (em_id, torch.full_like(u, 1.0 / n), lights.center[em],
            lights.radius[em], gather_rows((scene.emitters.radiance,), em)[0],
            scene.emitters.shape_id[em])


def _cone_pdf(c, r, p):
    """Solid-angle pdf of the cone toward a sphere (c, r) seen from p,
    and the cone's cos(theta_max) and squared center distance."""
    d2c = torch.clamp_min(length2(c - p), 1e-20)
    sin2max = r * r / d2c
    cos_max = torch.sqrt(torch.clamp_min(1.0 - sin2max, 0.0))
    return INV_TWOPI / torch.clamp_min(1.0 - cos_max, 1e-12), cos_max, d2c


def render_sample_direct(scene, lights: SphereLights, cam_consts,
                         cfg: DirectConfig, key, pixel_idx):
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
    nrays = torch.full((), b, dtype=torch.int64, device=d.device)

    le0 = emission_at(scene, it.mat_id)
    on_emitter = hit.valid & ~is_zero_rgb(le0)
    shade = hit.valid & ~on_emitter
    zero3 = torch.zeros_like(le0)
    lr = torch.where(on_emitter[..., None], le0, zero3)
    kd_ov = textured_kd(scene, it)

    def masked(ok, x):
        return torch.where(ok[..., None], x, zero3)

    def emitter_loop(n_samples, body, tag=5000):
        acc = zero3
        for i in range(n_samples):
            acc = acc + body(rng.lane_fold(lkeys, tag + i))
        return acc / max(n_samples, 1)

    def bsdf_hit(lk):
        """A BSDF sample, the emission it reaches and its hit."""
        u2 = rng.uniform2(rng.lane_fold(lk, rng.BSDF_SAMPLE))
        s = bsdf.sample_bsdf(scene.mat, it.mat_id, it.wo, u2, kd_ov)
        wi_w = frame_to_world(it.frame_ns, s.wi)
        h2 = trace_closest(scene, it.p, wi_w, EPSILON, torch.inf)
        it2 = make_interaction(scene, wi_w, h2)
        return s, h2, it2, emission_at(scene, it2.mat_id)

    if cfg.strategy == "area":
        def body(lk):
            u_sel = rng.uniform1(rng.lane_fold(lk, rng.EMITTER_SELECT))
            _, em_pdf, c, r, rad, _ = _select_emitter_sphere(scene, lights,
                                                             u_sel)
            u2 = rng.uniform2(rng.lane_fold(lk, rng.EMITTER_POSITION))
            ne = warp.square_to_uniform_sphere(u2)
            pos = ne * r[..., None] + c
            wi_w = normalize(pos - it.p)
            pdf = 1.0 / (4.0 * PI * r * r)
            dist2 = torch.clamp_min(length2(pos - it.p), 1e-20)
            cos_out = dot(-wi_w, ne)
            wi_l = frame_to_local(it.frame_ns, wi_w)
            ok = shade & (cos_out > 0.0) & (wi_l[..., 2] > 0.0)
            # Shadow ray to just short of the sampled point (direct.h:178).
            occ = trace_closest(scene, it.p, wi_w, EPSILON,
                                torch.sqrt(dist2) - EPSILON).valid
            ok = ok & ~occ
            a2s = cos_out / dist2
            f = bsdf.eval_bsdf(scene.mat, it.mat_id, it.wo, wi_l, kd_ov)
            return masked(ok, rad * f * (a2s / (pdf * em_pdf))[..., None])

        lr = lr + emitter_loop(cfg.emitter_samples, body)

    elif cfg.strategy == "cosineHemisphere":
        def body(lk):
            u2 = rng.uniform2(rng.lane_fold(lk, rng.EMITTER_POSITION))
            wi_l = warp.square_to_cosine_hemisphere(u2)
            wi_w = normalize(frame_to_world(it.frame_ns, wi_l))
            h2 = trace_closest(scene, it.p, wi_w, EPSILON, torch.inf)
            it2 = make_interaction(scene, wi_w, h2)
            le = emission_at(scene, it2.mat_id)
            pdf = warp.square_to_cosine_hemisphere_pdf(wi_l)
            safe = torch.where(pdf > 0, pdf, torch.ones_like(pdf))
            f = bsdf.eval_bsdf(scene.mat, it.mat_id, it.wo, wi_l, kd_ov)
            return masked(shade & h2.valid, le * f / safe[..., None])

        lr = lr + emitter_loop(cfg.emitter_samples, body)

    elif cfg.strategy == "bsdf":
        def body(lk):
            s, h2, _, le = bsdf_hit(lk)
            safe = torch.where(s.pdf > 0, s.pdf, torch.ones_like(s.pdf))
            return masked(shade & h2.valid, le * s.value / safe[..., None])

        lr = lr + emitter_loop(cfg.bsdf_samples, body)

    elif cfg.strategy in ("solidAngle", "mis"):
        is_mis = cfg.strategy == "mis"

        def body(lk):
            u_sel = rng.uniform1(rng.lane_fold(lk, rng.EMITTER_SELECT))
            _, em_pdf, c, r, rad, em_shape = _select_emitter_sphere(
                scene, lights, u_sel)
            u2 = rng.uniform2(rng.lane_fold(lk, rng.EMITTER_POSITION))
            # Cone sampling toward the bounding sphere (direct.h:111-141).
            cone_frame = make_frame(normalize(c - it.p))
            pdf, cos_max, d2c = _cone_pdf(c, r, it.p)
            wi_w = frame_to_world(cone_frame,
                                  warp.square_to_uniform_cone(u2, cos_max))
            wi_l = frame_to_local(it.frame_ns, wi_w)
            ok = shade & (wi_l[..., 2] > 0.0)
            # mis: unbounded shadow ray, shape-id check
            # (direct.h:377-381); solidAngle: shadow ray to the center
            # distance + eps (direct.h:304-330).
            maxt = torch.inf if is_mis else torch.sqrt(d2c) + EPSILON
            h2 = trace_closest(scene, it.p, wi_w, EPSILON, maxt)
            hit_shape = scene.shape_id[h2.tri.clamp_min(0).long()]
            vis = (h2.valid & (hit_shape == em_shape)) | (
                ~h2.valid & _ray_sphere_hit(it.p, wi_w, c, r, EPSILON, maxt))
            ok = ok & vis
            f = bsdf.eval_bsdf(scene.mat, it.mat_id, it.wo, wi_l, kd_ov)
            contrib = rad * f / (pdf * em_pdf)[..., None]
            if is_mis:
                b_pdf = bsdf.pdf_bsdf(scene.mat, it.mat_id, it.wo, wi_l,
                                      kd_ov)
                wgt = balance_heuristic(cfg.emitter_samples, pdf * em_pdf,
                                        cfg.bsdf_samples, b_pdf)
                contrib = contrib * wgt[..., None]
            return masked(ok, contrib)

        lr = lr + emitter_loop(cfg.emitter_samples, body)

        if is_mis and cfg.bsdf_samples > 0:
            def body_b(lk):
                s, h2, it2, le = bsdf_hit(lk)
                ok = shade & h2.valid & ~is_zero_rgb(le)
                em_id = torch.clamp_min(
                    scene.shape_emitter[it2.shape_id.long()], 0).long()
                em_sa_pdf, _, _ = _cone_pdf(lights.center[em_id],
                                            lights.radius[em_id], it.p)
                n_em = scene.emitters.radiance.shape[0]
                em_sa_pdf = em_sa_pdf * (1.0 / n_em)
                wgt = balance_heuristic(cfg.bsdf_samples, s.pdf,
                                        cfg.emitter_samples, em_sa_pdf)
                safe = torch.where(s.pdf > 0, s.pdf, torch.ones_like(s.pdf))
                return masked(ok, le * s.value * wgt[..., None]
                              / safe[..., None])

            lr = lr + emitter_loop(cfg.bsdf_samples, body_b, tag=6000)
    else:
        raise ValueError(f"unknown strategy {cfg.strategy!r}")

    fb = torch.zeros((w * h, 3), dtype=torch.float32, device=d.device)
    fb.index_add_(0, pixel_idx.long(), lr / cfg.spp)
    return fb, nrays


def render_image_direct(scene, meta, camera, cfg: DirectConfig,
                        seed: int = 0):
    """One sample at a time, sample s keyed fold_in(key(seed), s); returns
    the (H, W, 3) image and the total ray count."""
    device = scene.geom.v0.device
    lights = SphereLights(scene, meta)
    cam_consts = camera.device_constants(device)
    key = rng.key(seed, device)
    w, h = cfg.width, cfg.height
    pixel_idx = torch.arange(w * h, dtype=torch.int32, device=device)
    fb = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    total = 0
    for s in range(cfg.spp):
        fb_c, nr = render_sample_direct(scene, lights, cam_consts, cfg,
                                        rng.fold_in(key, s), pixel_idx)
        fb = fb + fb_c
        total += int(nr)
    return fb.reshape(h, w, 3), total
