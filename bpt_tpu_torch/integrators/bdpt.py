"""Bidirectional path tracer with VCM-style recursive MIS weights: port of
the reference package's bpt_tpu/integrators/bdpt.py.

`render_chunk` in BDPT mode (the default) takes the reference package's
default path, mega-connect with fused walks:

  1. camera rays and one closest-hit trace of the primaries;
  2. `fused_subpath_walks`: per depth, one closest-hit trace over the eye
     and light bounce rays together (2B lanes), BSDF sampling, Russian
     roulette and the vc/vcm MIS updates, with every visibility test
     deferred;
  3. `_mega_connect`: one any-hit trace over every connection segment of
     the sample (NEE, t=1 camera splats and the L x L eye x light pair
     grid); when the pair grid exceeds MEGA_MAX_LANES (deep Russian-
     roulette walks, many samples per batch) the pairs are traced in
     chunks of eye-depth rows instead (`_pair_connect_chunked`);
  4. two scatter-adds into the framebuffer.

The other modes take the solo walks with their visibility traced inside
the walk: `light_trace` runs `light_subpath_walk` (t=1 splats) and adds
the emitter seen by the primary ray; `path_trace` runs
`eye_subpath_walk` (s=0 on pure-specular paths and unweighted NEE).  So
does BDPT mode when the walks have no step (rr_depth < 2 in NO_RR mode).

Pooled light transport (`render_sample_pool`) replaces the per-pixel
light subpaths by a pool of cfg.light_pool light subpaths a sample,
keyed by pool index and shared by every pixel: the light walk and the
collecting eye walk trace their visibility in the walk, then
`connect_pool` connects every eye vertex to every pool vertex in chunks
of pool vertices, one any-hit trace a chunk.  `render_sample`,
`render_chunk` and `render_image` never read cfg.light_pool, as in the
reference; the pooled sample is driven by parallel/mesh.py.

`lax.scan` over depths is a Python loop; the reference's quirks (NO_RR
depth bound, the RR luminance gate, 1/(W*H) light-path counting, the s=0
position pdf) are kept verbatim, see bpt_tpu/integrators/bdpt.py.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import telemetry
from ..accel.api import Hit, trace_any, trace_closest
from ..bsdf import bsdf
from ..core import rng, warp
from ..core.camera import generate_rays, splat_to_image_plane
from ..core.math import (
    EPSILON,
    INV_TWOPI,
    VIS_SHORTEN,
    dot,
    frame_to_local,
    frame_to_world,
    is_zero_rgb,
    length,
    length2,
    luminance,
    make_frame,
)
from ..ops.gather import gather_rows
from ..scene.textures import albedo_at
from . import mis as mis_fn
from .common import (
    emission_at,
    make_interaction,
    sample_emitter_position,
    sample_lane_keys,
    textured_kd,
)

# Lane budget of one any-hit trace over the L x L x B pair grid of
# `_mega_connect` (the reference package's _MEGA_MAX_LANES default);
# larger grids are traced in chunks of eye-depth rows.  `connect_pool`
# sizes its chunks of pool vertices from the same budget.
MEGA_MAX_LANES = 8 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class BDPTConfig:
    """Render configuration (the reference package's fields)."""

    width: int
    height: int
    spp: int
    rr_depth: int = 5
    mode: str = "bdpt"             # bdpt | light_trace | path_trace
    no_rr: bool = True             # reference ships NO_RR=1 (bdpt.h:18)
    max_bounces: int = 32          # RR-mode hard cap (bdpt.h:66-67 has none)
    near: float = 1.0
    far: float = 1000.0
    # Per-technique toggles (default: all on = full BDPT), estimator
    # ablations and the bench's stage attribution.
    connect_t1: bool = True        # light-vertex -> camera splats
    connect_s1: bool = True        # next-event estimation
    connect_s2: bool = True        # all-pairs vertex connections
    # Profiling-only: False skips every occlusion trace (all segments
    # visible), so the image is wrong; it splits trace cost from shading.
    trace_vis: bool = True
    # Pooled light transport: the size of the global pool of light
    # subpaths a sample of `render_sample_pool` (parallel/mesh.py's
    # render_chunk_pool_ring); 0 and every other entry point: one light
    # subpath per pixel-sample (bdpt.h:219-241).
    light_pool: int = 0

    @property
    def n_steps(self) -> int:
        """Walk iterations: depth runs 1..rr_depth-1 in NO_RR mode
        (bdpt.h:68,188: `while depth < rrDepth`), up to max_bounces in RR
        mode."""
        if self.no_rr:
            return max(self.rr_depth - 1, 0)
        return self.max_bounces


class LightVertexSlots(NamedTuple):
    """Subpath vertices stacked (L, B, ...) by walk depth."""

    p: torch.Tensor
    ns: torch.Tensor          # shading normal
    wo: torch.Tensor          # local
    throughput: torch.Tensor
    vcm: torch.Tensor
    vc: torch.Tensor
    rr: torch.Tensor
    mat_id: torch.Tensor
    tri: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor


def _stack(records):
    """Stack a list of same-typed NamedTuples field by field."""
    return type(records[0])(*(torch.stack(f) for f in zip(*records)))


def _empty_slots(b, device):
    """LightVertexSlots of a walk with no step: (0, B, ...) fields."""
    z3 = torch.zeros((0, b, 3), dtype=torch.float32, device=device)
    z1 = torch.zeros((0, b), dtype=torch.float32, device=device)
    zi = torch.zeros((0, b), dtype=torch.int32, device=device)
    return LightVertexSlots(
        p=z3, ns=z3, wo=z3, throughput=z3, vcm=z1, vc=z1, rr=z1, mat_id=zi,
        tri=zi, u=z1, v=z1,
        valid=torch.zeros((0, b), dtype=torch.bool, device=device))


def _rr_probability(cfg: BDPTConfig, depth: int, throughput):
    """Continuation probability for the *next* bounce (reference:
    bdpt.h:129-132, 201-204): 1 in NO_RR mode and before rr_depth, else
    0.5 where the throughput's luminance is below 0.01."""
    one = torch.ones(throughput.shape[:-1], dtype=torch.float32,
                     device=throughput.device)
    if cfg.no_rr or depth + 1 < cfg.rr_depth:
        return one
    lum_low = luminance(throughput).detach() < 0.01
    return torch.where(lum_low, 0.5 * one, one)


def _rr_alive(cfg: BDPTConfig, lk, depth: int, alive, rr_prev):
    """Russian-roulette termination before the bounce of `depth` (reference:
    bdpt.h:66-67, 188-189); lk is the walk's key.  No key is derived
    where the test cannot fail (NO_RR mode, depth < rr_depth)."""
    if cfg.no_rr or depth < cfg.rr_depth:
        return alive
    kd = rng.lane_fold(lk, depth)
    u_rr = rng.uniform1(rng.lane_fold(kd, rng.RR))
    return alive & (u_rr < rr_prev)


def _continue_walk(lkeys, it, lane, rr_prob, throughput, vc, vcm, alive):
    """ContinuePathRandomWalk (reference: bdpt.h:243-291).  Returns
    (new_o, new_d, throughput, vc, vcm, alive, wi_local)."""
    thr_in, vc_in, vcm_in = throughput, vc, vcm
    u2 = rng.uniform2(rng.lane_fold(lkeys, rng.BSDF_SAMPLE))
    s = bsdf.sample_lane(lane, it.wo, u2)
    pdf_w = s.pdf * rr_prob
    abs_cos_out = torch.abs(s.wi[..., 2])
    dead = is_zero_rgb(s.value) | (pdf_w <= 0.0)
    safe_pdf = torch.where(dead, torch.ones_like(pdf_w), pdf_w)
    throughput = throughput * s.value / safe_pdf[..., None]

    # Reverse pdf; delta BSDFs reuse the forward pdf (bdpt.h:269-272).
    rev_pdf = bsdf.pdf_lane(lane, s.wi, it.wo) * rr_prob
    prev_rev_pdf = torch.where(s.delta, pdf_w, rev_pdf)

    vc, vcm = mis_fn.bounce_update(vc, vcm, abs_cos_out, safe_pdf,
                                   prev_rev_pdf, s.delta)

    d_world = frame_to_world(it.frame_ns, s.wi)
    alive_out = alive & ~dead
    # Freeze state on lanes that terminate here (or were already dead).
    throughput = torch.where(alive_out[..., None], throughput, thr_in)
    vc = torch.where(alive_out, vc, vc_in)
    vcm = torch.where(alive_out, vcm, vcm_in)
    return it.p, d_world, throughput, vc, vcm, alive_out, s.wi


def _kept_weight(mis, ok):
    """A detached MIS weight, zero on the lanes that `ok` rejects.  A
    rejected lane's weight denominator can vanish (its cosines may be
    negative), and 0 * inf in the backward of `value * weight` gives it a
    NaN gradient although the forward drops the lane; the reference
    multiplies first and masks after, so its gradient is NaN there.  The
    forward is unchanged: the kept lanes get the same weight."""
    return torch.where(ok, mis.detach(), torch.zeros_like(mis))


def _visible(scene, start, end, needed=None, trace_vis=True):
    """visibilityQuery: True where the segment is OCCLUDED
    (reference: bdpt.h:498-514), ray [EPSILON, dist - VIS_SHORTEN].
    Lanes with needed=False are traced as degenerate segments; with
    trace_vis=False nothing is traced and every segment is visible."""
    if not trace_vis:
        return torch.zeros(start.shape[:-1], dtype=torch.bool,
                           device=start.device)
    seg = end - start
    dist = length(seg)
    d = seg / torch.clamp_min(dist, 1e-20)[..., None]
    del seg  # the 8.3M-lane mega batch: free each column once consumed
    max_t = dist - VIS_SHORTEN
    if needed is not None:
        max_t = torch.where(needed, max_t, torch.full_like(max_t, -1.0))
    return trace_any(scene, start, d, EPSILON, max_t)


def _connect_to_camera(cam_consts, cfg: BDPTConfig, it, lane, throughput,
                       vcm, vc, rr_prob, active, n_light=None):
    """t=1: splat a light vertex onto the image plane (reference:
    bdpt.h:295-371, VCM Eqs. 46-47), visibility deferred.  n_light: the
    light-path count of the normalisation and the MIS weight, W*H by
    default (bdpt.h:330-351), the pool size in pooled mode.  Returns
    (pixel (B,), rgb (B,3), ok (B,)); rgb is weighted but not
    occlusion-masked, pixel == W*H on dropped lanes."""
    w, h = cfg.width, cfg.height
    eye_to_lv = it.p - cam_consts["o"]
    inv_d2 = 1.0 / torch.clamp_min(length2(eye_to_lv), 1e-20)
    dirn = eye_to_lv * torch.sqrt(inv_d2)[..., None]

    x_pix, y_pix, in_bounds = splat_to_image_plane(cam_consts, w, h, it.p)
    ok = active & in_bounds
    cos_cam = dot(cam_consts["forward"], dirn)
    ok &= cos_cam > 0.0

    wi_local = frame_to_local(it.frame_ns, -dirn)
    f, _, prev_rev = bsdf.eval_pdfs_lane(lane, it.wo, wi_local)
    ok &= ~is_zero_rgb(f) & (wi_local[..., 2] > 0.0)

    # Safe-masked denominators keep rejected lanes finite.
    one = torch.ones_like(cos_cam)
    vnpd = cam_consts["vnpd"]
    cos_safe = torch.where(ok, cos_cam, one)
    img_pt_dist = vnpd / cos_safe
    image_area_to_solid = img_pt_dist * img_pt_dist / cos_safe
    cam_solid_to_area = wi_local[..., 2] * inv_d2
    image_to_surf = image_area_to_solid * cam_solid_to_area

    if n_light is None:
        n_light = float(w * h)
    safe_z = torch.where(ok, torch.clamp_min(wi_local[..., 2], 1e-20), one)
    radiance = (throughput * f * (1.0 / safe_z)[..., None]
                * image_to_surf[..., None] * (1.0 / (n_light * cfg.spp)))

    if cfg.mode == "bdpt":
        prev_rev_pdf = prev_rev * rr_prob
        mis = _kept_weight(mis_fn.weight_t1(image_to_surf, n_light,
                                            prev_rev_pdf, vc, vcm), ok)
        radiance = radiance * mis[..., None]

    pixel = y_pix * w + x_pix
    pixel = torch.where(ok, pixel, torch.full_like(pixel, w * h))
    radiance = torch.where(ok[..., None], radiance,
                           torch.zeros_like(radiance))
    return pixel, radiance, ok


def _connect_to_light(scene, cfg: BDPTConfig, lkeys, it, lane, throughput,
                      vcm, vc, rr_prob, active):
    """s=1 next-event estimation (reference: bdpt.h:374-430, VCM Eqs.
    44-45), visibility deferred.  Returns (li (B,3), ok (B,), end (B,3))
    with li weighted (BDPT mode) but not occlusion-masked."""
    es = sample_emitter_position(scene, rng.lane_fold(lkeys, rng.NEE_WALK))

    l2e = it.p - es.pos
    dist2 = torch.clamp_min(length2(l2e), 1e-20)
    dirn = l2e / torch.sqrt(dist2)[..., None]

    wi_local = frame_to_local(it.frame_ns, -dirn)
    cos_at_light = dot(es.normal, dirn)
    cos_at_eye = wi_local[..., 2]
    ok = active & (cos_at_light > 0.0) & (cos_at_eye > 0.0)

    connect_pdf_a = es.select_pdf * es.pos_pdf
    cos_safe = torch.where(ok, torch.clamp_min(cos_at_light, 1e-20),
                           torch.ones_like(cos_at_light))
    connect_pdf_w = connect_pdf_a * dist2 / cos_safe
    dir_pdf_w = INV_TWOPI  # squareToUniformHemispherePdf

    f, pdf_f, pdf_r = bsdf.eval_pdfs_lane(lane, it.wo, wi_local)
    li = (f * throughput * es.radiance
          / torch.clamp_min(connect_pdf_w, 1e-30)[..., None])
    ok &= ~is_zero_rgb(li)

    if cfg.mode == "bdpt":
        light_rev_pdf_w = pdf_f * rr_prob
        eye_prev_rev_pdf_w = pdf_r * rr_prob
        eye_cur_rev_pdf_a = cos_at_eye / dist2 * dir_pdf_w
        mis = _kept_weight(mis_fn.weight_s1(
            light_rev_pdf_w, torch.clamp_min(connect_pdf_w, 1e-30),
            eye_cur_rev_pdf_a, eye_prev_rev_pdf_w, vc, vcm), ok)
        li = li * mis[..., None]
    return torch.where(ok[..., None], li, torch.zeros_like(li)), ok, es.pos


def _connect_vertices(lv_p, lv_frame, lv_wo, lv_thr, lv_vcm, lv_vc, lv_rr,
                      lv_lane, lv_valid, eye_p, eye_frame, eye_wo, eye_lane,
                      throughput, vcm, vc, rr_prob, active):
    """s>=2, t>=2 deterministic connection (reference: bdpt.h:434-483,
    VCM Eqs. 40-41), visibility deferred.  Light- and eye-side arguments
    broadcast against each other (the pair grid passes (1, L, B, ...)
    light arrays and (C, 1, B, ...) eye arrays).  Returns (li (...,3),
    ok (...)) with li weighted but not occlusion-masked."""
    l2e = eye_p - lv_p
    inv_d2 = 1.0 / torch.clamp_min(length2(l2e), 1e-20)
    dirn = l2e * torch.sqrt(inv_d2)[..., None]
    del l2e

    wi_light = frame_to_local(lv_frame, dirn)
    wi_eye = frame_to_local(eye_frame, -dirn)
    del dirn
    cos_l = wi_light[..., 2]
    cos_e = wi_eye[..., 2]
    ok = active & lv_valid & (cos_l > 0.0) & (cos_e > 0.0)

    f_l, pdf_l_f, pdf_l_r = bsdf.eval_pdfs_lane(lv_lane, lv_wo, wi_light)
    f_e, pdf_e_f, pdf_e_r = bsdf.eval_pdfs_lane(eye_lane, eye_wo, wi_eye)
    del wi_light, wi_eye
    li = f_l * f_e * lv_thr * throughput * inv_d2[..., None]
    del f_l, f_e

    pdf_l2e = pdf_l_f * lv_rr
    pdf_l_prev = pdf_l_r * lv_rr
    pdf_e2l = pdf_e_f * rr_prob
    pdf_e_prev = pdf_e_r * rr_prob

    light_rev_a = pdf_e2l * cos_l * inv_d2
    eye_rev_a = pdf_l2e * cos_e * inv_d2
    mis = _kept_weight(mis_fn.weight_connect(
        light_rev_a, pdf_l_prev, lv_vc, lv_vcm, eye_rev_a, pdf_e_prev, vc,
        vcm), ok)
    li = li * mis[..., None]
    return torch.where(ok[..., None], li, torch.zeros_like(li)), ok


# ---- light walk ----------------------------------------------------------

def _light_walk_init(scene, lkeys, b, primary_alive):
    """Light-walk setup (reference: bdpt.h:160-182): emitter position +
    direction, initial throughput and MIS state.  Returns (lk, carry)."""
    lk = rng.lane_fold(lkeys, rng.LIGHT_WALK)
    es = sample_emitter_position(scene, lk)
    u_dir = rng.uniform2(rng.lane_fold(lk, rng.EMITTER_DIRECTION))
    dir_local = warp.square_to_uniform_hemisphere(u_dir)
    cos_out = dir_local[..., 2]
    emitter_pdf = es.select_pdf
    emission_pdf = INV_TWOPI * es.pos_pdf * emitter_pdf  # bdpt.h:166,168
    area_pdf = es.pos_pdf * emitter_pdf                  # bdpt.h:167

    d = frame_to_world(make_frame(es.normal), dir_local)
    safe_emission_pdf = torch.clamp_min(emission_pdf, 1e-30)
    throughput = (cos_out[..., None] * es.radiance
                  / safe_emission_pdf[..., None])        # bdpt.h:173
    vc, vcm = mis_fn.light_walk_init(cos_out, safe_emission_pdf, area_pdf)
    alive = primary_alive & (cos_out > 0.0)              # bdpt.h:179-182
    dev = lkeys.device
    carry = (es.pos, d, throughput, vc, vcm, alive,
             torch.ones((b,), dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.int64, device=dev))
    return lk, carry


def _light_pre(cfg: BDPTConfig, lk, carry, depth: int):
    """Light-walk step, ray-build half: RR termination + the bounce ray.
    Dead lanes trace degenerate rays (max_t < min_t)."""
    o, d, throughput, vc, vcm, alive, rr_prev, nrays = carry
    alive = _rr_alive(cfg, lk, depth, alive, rr_prev)
    nrays = nrays + alive.sum()
    max_t = torch.where(alive, torch.inf, -1.0).to(torch.float32)
    return (o, d, throughput, vc, vcm, alive, rr_prev, nrays), (
        o, d, EPSILON, max_t)


def _light_post(scene, cam_consts, cfg: BDPTConfig, lk, defer_t1, b, carry,
                depth: int, hit, n_light=None):
    """Light-walk step, hit-consume half (reference: bdpt.h:186-215).
    With defer_t1 the t=1 occlusion is left to the caller and t1_ok is
    returned; otherwise it is traced here and the splats are final.
    n_light: the t=1 splats' light-path count (see _connect_to_camera)."""
    o, d, throughput, vc, vcm, alive, rr_prev, nrays = carry
    kd = rng.lane_fold(lk, depth)
    wh = cfg.width * cfg.height

    alive = alive & hit.valid
    it = make_interaction(scene, d, hit)

    dist2 = hit.t * hit.t
    abs_cos_in = torch.clamp_min(torch.abs(it.wo[..., 2]), 1e-20)
    # Freeze dead lanes' MIS state (it could overflow across steps).
    vc_u, vcm_u = mis_fn.measure_update(vc, vcm, dist2, abs_cos_in)
    vcm = torch.where(alive, vcm_u, vcm)
    vc = torch.where(alive, vc_u, vc)

    rr_prob = _rr_probability(cfg, depth, throughput)
    lane = bsdf.gather_lane(scene.mat, it.mat_id, textured_kd(scene, it))
    delta = bsdf.is_delta(lane)

    if cfg.connect_t1:
        pix, rgb, okc = _connect_to_camera(
            cam_consts, cfg, it, lane, throughput, vcm, vc, rr_prob,
            alive & ~delta, n_light=n_light)
        if not defer_t1:
            occ = _visible(scene, cam_consts["o"].expand(it.p.shape), it.p,
                           needed=okc, trace_vis=cfg.trace_vis)
            if cfg.trace_vis:
                nrays = nrays + okc.sum()
            okc = okc & ~occ
            pix = torch.where(okc, pix, torch.full_like(pix, wh))
            rgb = torch.where(okc[..., None], rgb, torch.zeros_like(rgb))
    else:  # ablation: walk and vertex storage stay identical
        dev = it.p.device
        pix = torch.full((b,), wh, dtype=torch.int32, device=dev)
        rgb = torch.zeros((b, 3), dtype=torch.float32, device=dev)
        okc = torch.zeros((b,), dtype=torch.bool, device=dev)

    o2, d2, thr2, vc2, vcm2, alive2, _ = _continue_walk(
        kd, it, lane, rr_prob, throughput, vc, vcm, alive)
    vertex_valid = alive & ~delta & alive2  # push-after-continue,
    # reference bdpt.h:211-215

    vertex = LightVertexSlots(
        p=it.p, ns=it.frame_ns[..., 2, :], wo=it.wo, throughput=throughput,
        vcm=vcm, vc=vc, rr=rr_prob, mat_id=it.mat_id, tri=it.tri, u=it.u,
        v=it.v, valid=vertex_valid)
    return (o2, d2, thr2, vc2, vcm2, alive2, rr_prob, nrays), (
        vertex, pix, rgb, okc if defer_t1 else None)


def light_subpath_walk(scene, cam_consts, cfg: BDPTConfig, lkeys, b,
                       primary_alive, n_light=None):
    """Light walk of light_trace mode and of the pool (reference:
    bdpt.h:158-217), one closest-hit trace of B rays a depth, each depth's
    t=1 occlusion traced in the walk.  n_light: the t=1 splats'
    light-path count, W*H by default; pooled mode passes the pool size and
    B is the pool shard's.  Returns (slots (L, B, ...), splat_pixels
    (L, B), splat_rgb (L, B, 3), ray_count)."""
    l = cfg.n_steps
    dev = lkeys.device
    if l == 0:
        return (_empty_slots(b, dev),
                torch.zeros((0, b), dtype=torch.int32, device=dev),
                torch.zeros((0, b, 3), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    lk, carry = _light_walk_init(scene, lkeys, b, primary_alive)
    ys = []
    for depth in range(1, l + 1):
        carry, (ro, rd, rmn, rmx) = _light_pre(cfg, lk, carry, depth)
        hit = trace_closest(scene, ro, rd, rmn, rmx)
        carry, y = _light_post(scene, cam_consts, cfg, lk, False, b, carry,
                               depth, hit, n_light)
        ys.append(y)
    slots = _stack([y[0] for y in ys])
    pix = torch.stack([y[1] for y in ys])
    rgb = torch.stack([y[2] for y in ys])
    return slots, pix, rgb, carry[-1]


# ---- eye walk ------------------------------------------------------------

def _eye_walk_init(cam_consts, cfg: BDPTConfig, primary_d, n_light=None):
    """Eye-walk carry (reference: bdpt.h:49-62): camera origin, primary
    directions, unit throughput and the t=1 pdf's MIS state with n_light
    light paths (W*H by default, the pool size in pooled mode)."""
    b = primary_d.shape[0]
    dev = primary_d.device
    cos_cam = dot(cam_consts["forward"], primary_d)
    img_pt_dist = cam_consts["vnpd"] / torch.clamp_min(cos_cam, 1e-20)
    t1_pdf = img_pt_dist * img_pt_dist / torch.clamp_min(cos_cam, 1e-20)
    if n_light is None:
        n_light = float(cfg.width * cfg.height)
    vc, vcm = mis_fn.eye_walk_init(n_light, t1_pdf)
    return (cam_consts["o"].expand(primary_d.shape), primary_d,
            torch.ones((b, 3), dtype=torch.float32, device=dev), vc, vcm,
            torch.ones((b,), dtype=torch.bool, device=dev),
            torch.ones((b,), dtype=torch.float32, device=dev),
            torch.ones((b,), dtype=torch.bool, device=dev),
            torch.zeros((b, 3), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def _eye_pre(cfg: BDPTConfig, lk_eye, carry, depth: int):
    """Eye-walk step, ray-build half: RR termination + the bounce ray.
    Primary rays carry the [near, far] window (renderer.cpp:177,192);
    bounce rays are unbounded; dead lanes trace degenerate rays."""
    (o, d, throughput, vc, vcm, alive, rr_prev, pure_spec, li,
     nrays) = carry
    alive = _rr_alive(cfg, lk_eye, depth, alive, rr_prev)
    nrays = nrays + alive.sum()
    min_t = cfg.near if depth == 1 else EPSILON
    max_t = cfg.far if depth == 1 else torch.inf
    carry = (o, d, throughput, vc, vcm, alive, rr_prev, pure_spec, li,
             nrays)
    return carry, (o, d, min_t,
                   torch.where(alive, max_t, -1.0).to(torch.float32))


def _eye_post(scene, cfg: BDPTConfig, lk_eye, defer_connect, carry,
              depth: int, hit, collect=False):
    """Eye-walk step, hit-consume half (reference: bdpt.h:68-152).  NEE is
    shaded here; with defer_connect its segments and the eye vertex are
    returned for the caller's connect, otherwise NEE is traced here and,
    with collect, the eye vertex alone is returned."""
    (o, d, throughput, vc, vcm, alive, rr_prev, pure_spec, li,
     nrays) = carry
    kd = rng.lane_fold(lk_eye, depth)
    n_emitters = scene.emitters.radiance.shape[0]
    alive = alive & hit.valid
    it = make_interaction(scene, d, hit)

    dist2 = hit.t * hit.t
    abs_cos_in = torch.clamp_min(torch.abs(it.wo[..., 2]), 1e-20)
    vc_u, vcm_u = mis_fn.measure_update(vc, vcm, dist2, abs_cos_in)
    vcm = torch.where(alive, vcm_u, vcm)
    vc = torch.where(alive, vc_u, vc)

    # ---- s=0: the eye path hit an emitter (bdpt.h:79-125) ----
    le = emission_at(scene, it.mat_id)
    hit_emitter = alive & ~is_zero_rgb(le)
    zero3 = torch.zeros_like(le)
    if depth == 1:
        li = li + torch.where(hit_emitter[..., None], le, zero3)
    elif cfg.mode != "light_trace":  # the light tracer has no s=0
        em_id = torch.clamp_min(scene.shape_emitter[it.shape_id.long()],
                                0).long()
        (radiance,) = gather_rows((scene.emitters.radiance,), em_id)
        contrib = radiance * throughput
        add = hit_emitter
        if cfg.mode == "bdpt":
            em_area = scene.emitters.area[em_id]
            # Replicated verbatim: 1/(area*emitterPdf) (bdpt.h:87).
            pos_pdf_a = 1.0 / (em_area * (1.0 / n_emitters))
            mis_s0 = mis_fn.weight_s0(pos_pdf_a, INV_TWOPI, vc, vcm).detach()
            contrib = contrib * torch.where(
                pure_spec, torch.ones_like(mis_s0), mis_s0)[..., None]
        else:  # path_trace: s=0 only where NEE could not reach the light
            add = add & pure_spec
        li = li + torch.where(add[..., None], contrib, zero3)
    alive = alive & ~hit_emitter  # break (bdpt.h:124)

    rr_prob = _rr_probability(cfg, depth, throughput)
    lane = bsdf.gather_lane(scene.mat, it.mat_id, textured_kd(scene, it))
    delta = bsdf.is_delta(lane)
    connectable = alive & ~delta
    pure_spec = pure_spec & ~connectable  # bdpt.h:139

    # ---- s=1 NEE (bdpt.h:142) ----
    nee = None
    if cfg.connect_s1:
        nee = _connect_to_light(scene, cfg, kd, it, lane, throughput, vcm,
                                vc, rr_prob, connectable)
        if not defer_connect:
            nee_li, nee_ok, nee_end = nee
            occ = _visible(scene, it.p, nee_end, needed=nee_ok,
                           trace_vis=cfg.trace_vis)
            if cfg.trace_vis:
                nrays = nrays + nee_ok.sum()
            li = li + torch.where(occ[..., None], torch.zeros_like(nee_li),
                                  nee_li)
    elif defer_connect:  # connect_s1 ablation: empty NEE rows
        b = it.p.shape[0]
        nee = (torch.zeros_like(it.p),
               torch.zeros((b,), dtype=torch.bool, device=it.p.device),
               torch.zeros_like(it.p))

    o2, d2, thr2, vc2, vcm2, alive2, _ = _continue_walk(
        kd, it, lane, rr_prob, throughput, vc, vcm, alive)
    ys = None
    if collect or defer_connect:
        # The eye vertex as the s>=2 connection uses it at THIS depth
        # (pre-continue state, bdpt.h:142-152).
        ys = LightVertexSlots(
            p=it.p, ns=it.frame_ns[..., 2, :], wo=it.wo,
            throughput=throughput, vcm=vcm, vc=vc, rr=rr_prob,
            mat_id=it.mat_id, tri=it.tri, u=it.u, v=it.v, valid=connectable)
    if defer_connect:
        ys = (ys, nee)
    return (o2, d2, thr2, vc2, vcm2, alive2, rr_prob, pure_spec, li,
            nrays), ys


def eye_subpath_walk(scene, cam_consts, cfg: BDPTConfig, lkeys, primary_d,
                     n_light=None, collect=False):
    """Eye walk of path_trace mode and of the pool (reference:
    bdpt.h:46-155), one closest-hit trace of B rays a depth, with s=0 and
    NEE traced in the walk.  n_light: the MIS light-path count, W*H by
    default, the pool size in pooled mode.  Returns (li (B,3),
    ray_count), and with collect also the (L, B) eye-vertex slots that
    `connect_pool` connects."""
    b = primary_d.shape[0]
    l = cfg.n_steps
    dev = primary_d.device
    li = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    if l == 0:
        return (li, nrays, _empty_slots(b, dev)) if collect else (li, nrays)
    lk_eye = rng.lane_fold(lkeys, rng.EYE_WALK)  # loop-invariant
    carry = _eye_walk_init(cam_consts, cfg, primary_d, n_light)
    ys = []
    for depth in range(1, l + 1):
        carry, (ro, rd, rmn, rmx) = _eye_pre(cfg, lk_eye, carry, depth)
        hit = trace_closest(scene, ro.expand(b, 3), rd, rmn, rmx)
        carry, y = _eye_post(scene, cfg, lk_eye, False, carry, depth, hit,
                             collect)
        ys.append(y)
    if collect:
        return carry[-2], carry[-1], _stack(ys)
    return carry[-2], carry[-1]


@telemetry.spanned("bdpt.walks")
def fused_subpath_walks(scene, cam_consts, cfg: BDPTConfig, lkeys, b,
                        primary_d, primary_alive):
    """Both subpath walks of BDPT mode in one loop over depths, visibility
    fully deferred (the solo walks' RNG streams and per-step math): each
    depth runs ONE closest-hit trace over the 2B eye and light bounce
    rays.

    Returns (light_slots, t1_pix, t1_rgb, t1_ok, li_s0, eye_slots,
    (nee_li, nee_ok, nee_end), nrays), per-depth arrays stacked (L, B)."""
    l = cfg.n_steps
    lk_l, lc = _light_walk_init(scene, lkeys, b, primary_alive)
    lk_e = rng.lane_fold(lkeys, rng.EYE_WALK)
    ec = _eye_walk_init(cam_consts, cfg, primary_d)

    dev = primary_d.device
    eye_ys, light_ys = [], []
    for depth in range(1, l + 1):
        ec, (eo, ed, emn, emx) = _eye_pre(cfg, lk_e, ec, depth)
        lc, (lo, ld, lmn, lmx) = _light_pre(cfg, lk_l, lc, depth)
        o = torch.cat([eo.expand(b, 3), lo])
        d = torch.cat([ed, ld])
        mn = torch.cat([torch.full((b,), emn, dtype=torch.float32,
                                   device=dev),
                        torch.full((b,), lmn, dtype=torch.float32,
                                   device=dev)])
        mx = torch.cat([emx, lmx])
        hit = trace_closest(scene, o, d, mn, mx)
        eh = Hit(*(a[:b] for a in hit))
        lh = Hit(*(a[b:] for a in hit))
        ec, eys = _eye_post(scene, cfg, lk_e, True, ec, depth, eh)
        lc, lys = _light_post(scene, cam_consts, cfg, lk_l, True, b, lc,
                              depth, lh)
        eye_ys.append(eys)
        light_ys.append(lys)

    eye_slots = _stack([y[0] for y in eye_ys])
    nee_pack = tuple(torch.stack(f) for f in zip(*(y[1] for y in eye_ys)))
    light_slots = _stack([y[0] for y in light_ys])
    t1_pix, t1_rgb, t1_ok = (torch.stack(f) for f in
                             zip(*(y[1:] for y in light_ys)))
    li_s0 = ec[-2]
    nrays = ec[-1] + lc[-1]
    return (light_slots, t1_pix, t1_rgb, t1_ok, li_s0, eye_slots, nee_pack,
            nrays)


# ---- connections ---------------------------------------------------------

def _slot_lanes(scene, slots: LightVertexSlots, shape):
    """LaneMaterial (textured Kd folded in) of every (L, B) slot, each
    field viewed as `shape` + its trailing dims."""
    lb = slots.valid.numel()
    kd = albedo_at(scene, slots.tri.reshape(lb), slots.u.reshape(lb),
                   slots.v.reshape(lb))
    lane = bsdf.gather_lane(scene.mat, slots.mat_id.reshape(lb), kd)
    return type(lane)(*(a.reshape(shape + a.shape[1:]) for a in lane))


class _PairSides(NamedTuple):
    """Loop-invariant data of the pair grid: both sides' slots with their
    lane materials ((1, L, B) light, (L, 1, B) eye) and frames."""

    light: LightVertexSlots
    lv_lane: bsdf.LaneMaterial
    lv_frame: torch.Tensor
    eye: LightVertexSlots
    eye_lane: bsdf.LaneMaterial
    eye_frame: torch.Tensor


def _pair_sides(scene, eye_slots, light_slots):
    l, b = eye_slots.valid.shape
    return _PairSides(
        light_slots, _slot_lanes(scene, light_slots, (1, l, b)),
        make_frame(light_slots.ns), eye_slots,
        _slot_lanes(scene, eye_slots, (l, 1, b)), make_frame(eye_slots.ns))


def _pair_rows(sides: _PairSides, rows: slice):
    """Shade the pairs of eye-depth rows `rows` against every light slot
    by broadcasting (C, 1, B) eye arrays against (1, L, B) light arrays.
    Returns (li (C, L, B, 3), ok (C, L, B), start, end), the segment
    endpoints as (C, L, B, 3) broadcast views (nothing copied yet)."""
    lv, ev = sides.light, sides.eye

    def es(a):  # eye side: repeats along the light-slot axis
        return a[rows, None]

    c_li, c_ok = _connect_vertices(
        lv.p[None], sides.lv_frame[None], lv.wo[None], lv.throughput[None],
        lv.vcm[None], lv.vc[None], lv.rr[None], sides.lv_lane,
        lv.valid[None],
        es(ev.p), es(sides.eye_frame), es(ev.wo),
        type(sides.eye_lane)(*(a[rows] for a in sides.eye_lane)),
        es(ev.throughput), es(ev.vcm), es(ev.vc), es(ev.rr), es(ev.valid))
    shape = c_ok.shape + (3,)
    return c_li, c_ok, es(ev.p).expand(shape), lv.p[None].expand(shape)


@telemetry.spanned("bdpt.connect")
def _mega_connect(scene, cam_consts, cfg: BDPTConfig,
                  eye_slots: LightVertexSlots,
                  light_slots: LightVertexSlots,
                  nee_li, nee_ok, nee_end, t1_pix, t1_rgb, t1_ok):
    """Resolve every connection segment of one sample in ONE any-hit
    trace: s=1 NEE (L*B), t=1 camera splats (L*B) and the s>=2 pair grid
    (L*L*B per-pixel eye-depth x light-slot pairs, the reference's nested
    loop bdpt.h:145-149).  A pair grid above MEGA_MAX_LANES is left out
    of that trace and traced in chunks of eye-depth rows
    (`_pair_connect_chunked`).  The toggles of cfg drop their segments;
    t1_ok None means no t=1 splats.

    Only the per-pair results and the segment endpoints are L*L*B wide
    (broadcast shading, see `_pair_rows`).

    Returns (li_connect (B,3), splat_pix (L*B,), splat_rgb (L*B,3),
    n_vis_rays)."""
    l, b = eye_slots.valid.shape
    lb = l * b
    wh = cfg.width * cfg.height
    dev = eye_slots.p.device
    li = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    if t1_ok is None:
        t1_pix = torch.full((lb,), wh, dtype=torch.int32, device=dev)
        t1_rgb = torch.zeros((lb, 3), dtype=torch.float32, device=dev)
    else:
        t1_pix, t1_rgb = t1_pix.reshape(lb), t1_rgb.reshape(lb, 3)

    # Segments in the order NEE (L*B), t=1 (L*B), pairs (L*L*B).
    starts, ends, oks = [], [], []
    if cfg.connect_s1:
        starts.append(eye_slots.p.reshape(lb, 3))
        ends.append(nee_end.reshape(lb, 3))
        oks.append(nee_ok.reshape(lb))
    has_t1 = cfg.connect_t1 and t1_ok is not None
    if has_t1:
        starts.append(cam_consts["o"].expand(lb, 3))
        ends.append(light_slots.p.reshape(lb, 3))
        oks.append(t1_ok.reshape(lb))
    chunked = cfg.connect_s2 and l * lb > MEGA_MAX_LANES
    c_li = None
    if cfg.connect_s2 and not chunked:
        c_li, c_ok, start, end = _pair_rows(
            _pair_sides(scene, eye_slots, light_slots), slice(None))
        starts.append(start)
        ends.append(end)
        oks.append(c_ok.reshape(-1))
        del start, end, c_ok

    if starts:
        ok_all = torch.cat(oks)
        start_all = torch.cat([p.reshape(-1, 3) for p in starts])
        end_all = torch.cat([p.reshape(-1, 3) for p in ends])
        del starts, ends
        occ = _visible(scene, start_all, end_all, needed=ok_all,
                       trace_vis=cfg.trace_vis)
        del start_all, end_all  # the 8.3M-lane endpoints
        vis = ~occ
        if cfg.trace_vis:
            nrays = ok_all.sum()
        off = 0
        if cfg.connect_s1:
            li = li + torch.where(vis[:lb].reshape(l, b, 1), nee_li,
                                  torch.zeros_like(nee_li)).sum(dim=0)
            off = lb
        if has_t1:
            ok2 = t1_ok.reshape(lb) & vis[off:off + lb]
            t1_pix = torch.where(ok2, t1_pix, torch.full_like(t1_pix, wh))
            t1_rgb = torch.where(ok2[..., None], t1_rgb,
                                 torch.zeros_like(t1_rgb))
            off += lb
        if c_li is not None:
            c = torch.where(vis[off:].reshape(l, l, b, 1), c_li,
                            torch.zeros_like(c_li))
            li = li + c.sum(dim=(0, 1))
    if chunked:
        li_p, nr_p = _pair_connect_chunked(scene, cfg, eye_slots,
                                           light_slots)
        li = li + li_p
        nrays = nrays + nr_p
    return li, t1_pix, t1_rgb, nrays


def _pair_connect_chunked(scene, cfg: BDPTConfig,
                          eye_slots: LightVertexSlots,
                          light_slots: LightVertexSlots):
    """s>=2 all-pairs connect in chunks of C eye-depth rows, one any-hit
    trace of C*L*B pair lanes each, C = MEGA_MAX_LANES // (L*B) (at least
    one row; the last chunk may hold fewer).  Light-side lane data and
    both sides' frames are gathered once.  Returns (li (B,3),
    n_vis_rays)."""
    l, b = eye_slots.valid.shape
    c = max(1, min(l, MEGA_MAX_LANES // (l * b)))
    sides = _pair_sides(scene, eye_slots, light_slots)
    li = torch.zeros((b, 3), dtype=torch.float32, device=eye_slots.p.device)
    nrays = torch.zeros((), dtype=torch.int64, device=eye_slots.p.device)
    for r0 in range(0, l, c):
        c_li, c_ok, start, end = _pair_rows(sides, slice(r0, r0 + c))
        occ = _visible(scene, start.reshape(-1, 3), end.reshape(-1, 3),
                       needed=c_ok.reshape(-1), trace_vis=cfg.trace_vis)
        del start, end
        li = li + torch.where(occ.reshape(c_ok.shape + (1,)),
                              torch.zeros_like(c_li), c_li).sum(dim=(0, 1))
        if cfg.trace_vis:
            nrays = nrays + c_ok.sum()
        del c_li, c_ok, occ  # free this chunk's arrays before the next
    return li, nrays


def connect_pool(scene, cfg: BDPTConfig, eye_slots: LightVertexSlots,
                 pool_slots: LightVertexSlots, n_pool: int, chunk=None):
    """Pooled mode's s>=2 phase: every eye vertex connected to every
    vertex of one shard of the light pool (reference: bdpt.h:145-149 with
    one pool shared by every pixel), averaged over the n_pool paths of
    the whole pool.

    eye_slots: (L_e, B, ...) from eye_subpath_walk(collect=True);
    pool_slots: (L_p, P, ...), the shard the caller holds; n_pool: the
    total pool path count.  The pairs go in chunks of `chunk` pool
    vertices, one any-hit trace of chunk * L_e * B segments each (the
    last chunk holds the rest); by default as many vertices as
    MEGA_MAX_LANES holds.  Both sides' lane materials and frames are
    gathered once.  Returns (li (B,3), n_vis_rays)."""
    l_e, b = eye_slots.valid.shape
    e = l_e * b
    lp = pool_slots.valid.numel()
    dev = eye_slots.p.device
    li = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    if e == 0 or lp == 0:
        return li, nrays
    if chunk is None:
        chunk = max(1, min(lp, MEGA_MAX_LANES // e))

    def flat(slots, shape):  # (L, N, ...) fields -> shape + (...)
        return type(slots)(*(a.reshape(shape + a.shape[2:]) for a in slots))

    pool = flat(pool_slots, (lp,))
    pool_lane = _slot_lanes(scene, pool_slots, (lp,))
    pool_frame = make_frame(pool.ns)
    eye = flat(eye_slots, (1, e))
    eye_lane = _slot_lanes(scene, eye_slots, (1, e))
    eye_frame = make_frame(eye.ns)
    for c0 in range(0, lp, chunk):
        def ps(a):  # pool side: (C, 1, ...), each vertex against every eye
            return a[c0:c0 + chunk, None]

        c_li, c_ok = _connect_vertices(
            ps(pool.p), ps(pool_frame), ps(pool.wo), ps(pool.throughput),
            ps(pool.vcm), ps(pool.vc), ps(pool.rr),
            type(pool_lane)(*(ps(a) for a in pool_lane)), ps(pool.valid),
            eye.p, eye_frame, eye.wo, eye_lane, eye.throughput, eye.vcm,
            eye.vc, eye.rr, eye.valid)
        shape = c_ok.shape + (3,)
        occ = _visible(scene, eye.p.expand(shape).reshape(-1, 3),
                       ps(pool.p).expand(shape).reshape(-1, 3),
                       needed=c_ok.reshape(-1), trace_vis=cfg.trace_vis)
        c = torch.where(occ.reshape(c_ok.shape + (1,)),
                        torch.zeros_like(c_li), c_li)
        # Fold the chunk's pool vertices and the eye depths -> (B, 3).
        li = li + c.reshape(-1, l_e, b, 3).sum(dim=(0, 1))
        if cfg.trace_vis:
            nrays = nrays + c_ok.sum()
        del c_li, c_ok, occ, c  # free this chunk's arrays before the next
    return li / float(n_pool), nrays


# ---- rendering -----------------------------------------------------------

def _accumulate(fb, cfg: BDPTConfig, pixel_idx, li, splat_pix, splat_rgb):
    """Add a sample's eye contributions `li` (B, 3) at their pixels, over
    cfg.spp, and its light splats (None: none) into `fb` (W*H + 1, 3),
    whose last row takes the splats that miss the image; return its W*H
    pixels."""
    # index_add_ on CUDA accumulates with atomics in run-dependent order.
    with telemetry.span("bdpt.splat"):
        fb.index_add_(0, pixel_idx.long(), li / cfg.spp)
        if splat_pix is not None and splat_pix.numel():
            fb.index_add_(0, splat_pix.reshape(-1).long(),
                          splat_rgb.reshape(-1, 3))
    return fb[: cfg.width * cfg.height]


def render_sample(scene, cam_consts, cfg: BDPTConfig, key, pixel_idx,
                  lkeys=None):
    """One pixel-sample per lane -> dense (W*H, 3) framebuffer increment
    (eye contributions at their pixel, light splats anywhere) and the ray
    count (reference: bdpt.h:219-241, renderer.cpp:183-207).

    lkeys: optional (B, 2) lane keys; callers batching several samples
    pass per-(pixel, sample) keys (key is then unused).  Without them the
    lanes are keyed by pixel: rng.lane_keys(key, pixel_idx)."""
    b = pixel_idx.shape[0]
    w, h = cfg.width, cfg.height
    if lkeys is None:
        lkeys = rng.lane_keys(key, pixel_idx)

    jitter = None
    if cfg.spp > 1:
        jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    o, d = generate_rays(cam_consts, w, h, pixel_idx, jitter)

    primary_hit = trace_closest(scene, o, d, cfg.near, cfg.far)
    primary_alive = primary_hit.valid
    nrays = torch.full((), b, dtype=torch.int64, device=d.device)
    fb = torch.zeros((w * h + 1, 3), dtype=torch.float32, device=d.device)

    if cfg.mode == "bdpt" and cfg.n_steps > 0:
        (slots, t1_pix, t1_rgb, t1_ok, li, eye_slots,
         (nee_li, nee_ok, nee_end), nr_w) = fused_subpath_walks(
            scene, cam_consts, cfg, lkeys, b, d, primary_alive)
        nrays = nrays + nr_w
        li_c, splat_pix, splat_rgb, nr_c = _mega_connect(
            scene, cam_consts, cfg, eye_slots, slots, nee_li, nee_ok,
            nee_end, t1_pix, t1_rgb, t1_ok if cfg.connect_t1 else None)
        nrays = nrays + nr_c
        li = li + li_c
    else:
        splat_pix = splat_rgb = None
        if cfg.mode in ("bdpt", "light_trace"):
            _, splat_pix, splat_rgb, nr_l = light_subpath_walk(
                scene, cam_consts, cfg, lkeys, b, primary_alive)
            nrays = nrays + nr_l
        if cfg.mode == "light_trace":
            # The emitter seen by the primary ray (s=0, t=2).
            li = emission_at(scene, make_interaction(scene, d,
                                                     primary_hit).mat_id)
        else:
            li, nr_e = eye_subpath_walk(scene, cam_consts, cfg, lkeys, d)
            nrays = nrays + nr_e
    li = torch.where(primary_alive[..., None], li, torch.zeros_like(li))
    return _accumulate(fb, cfg, pixel_idx, li, splat_pix, splat_rgb), nrays


def render_sample_pool(scene, cam_consts, cfg: BDPTConfig, key, pixel_idx,
                       pool_ids, rotate_fn=None, n_ring=1, lkeys=None):
    """One sample of pooled light transport (cfg.light_pool > 0): a pool
    of cfg.light_pool light subpaths shared by every pixel.  Each eye
    vertex connects to every pool vertex with 1/N averaging, the t=1
    splats come from the pool with the same path count, s=0 and s=1 stay
    per eye vertex; every MIS weight counts N light paths.

    pool_ids: (P,) global pool indices of the shard this caller holds, on
    the scene's device; the pool walks are keyed by them, so the
    estimate does not depend on how the pool is sharded.  rotate_fn,
    n_ring: the hooks of parallel/mesh.py's pool ring: n_ring
    connect_pool passes, rotate_fn(slots) handing the shard on between
    them.  The defaults connect the whole pool in one pass.  lkeys: as
    render_sample's.

    Returns (framebuffer (W*H, 3), n_rays)."""
    b = pixel_idx.shape[0]
    w, h = cfg.width, cfg.height
    n_pool = cfg.light_pool
    if lkeys is None:
        lkeys = rng.lane_keys(key, pixel_idx)

    jitter = None
    if cfg.spp > 1:
        jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    o, d = generate_rays(cam_consts, w, h, pixel_idx, jitter)

    primary_hit = trace_closest(scene, o, d, cfg.near, cfg.far)
    nrays = torch.full((), b, dtype=torch.int64, device=d.device)

    # The pool's light walk, keyed by global pool index.
    p = pool_ids.shape[0]
    pkeys = rng.lane_keys(rng.stream(key, rng.POOL_WALK), pool_ids)
    pool_slots, splat_pix, splat_rgb, nr_l = light_subpath_walk(
        scene, cam_consts, cfg, pkeys, p,
        torch.ones((p,), dtype=torch.bool, device=d.device),
        n_light=float(n_pool))
    nrays = nrays + nr_l

    # Eye walk: s=0 and s=1, its vertices collected for the pool.
    li, nr_e, eye_slots = eye_subpath_walk(
        scene, cam_consts, cfg, lkeys, d, n_light=float(n_pool),
        collect=True)
    nrays = nrays + nr_e

    # s>=2 against the pool, one pass per ring shard.
    if cfg.connect_s2 and cfg.n_steps > 0:
        cur = pool_slots
        for r in range(n_ring):
            li_c, nv = connect_pool(scene, cfg, eye_slots, cur, n_pool)
            li = li + li_c
            nrays = nrays + nv
            if rotate_fn is not None and r + 1 < n_ring:
                cur = rotate_fn(cur)
    li = torch.where(primary_hit.valid[..., None], li, torch.zeros_like(li))

    fb = torch.zeros((w * h + 1, 3), dtype=torch.float32, device=d.device)
    return _accumulate(fb, cfg, pixel_idx, li, splat_pix, splat_rgb), nrays


def _blocked_pixel_order(w: int, h: int, device, bs: int = 16):
    """Pixel ids ordered by bs x bs screen blocks, so consecutive lanes
    (and their bounce rays and segments) stay spatially coherent."""
    idx = torch.arange(w * h, dtype=torch.int32, device=device)
    if w % bs or h % bs:
        return idx
    idx = idx.reshape(h // bs, bs, w // bs, bs)
    return idx.permute(0, 2, 1, 3).reshape(-1)


@telemetry.spanned("bdpt.render_chunk")
def render_chunk(scene, cam_consts, cfg: BDPTConfig, key, spp_chunk: int = 1,
                 sample_offset: int = 0, samples_per_batch: int = 1):
    """Render `spp_chunk` full-image samples into one framebuffer.

    Sample s is keyed fold_in(key, sample_offset + s) and every lane by
    its pixel, so the estimate does not depend on chunking or on
    samples_per_batch (samples fused into one wavefront batch of
    sb * W * H lanes).  The buffer is already divided by cfg.spp.  The
    key must lie on the scene's device.
    Returns (fb (W*H, 3), nrays 0-dim int64 tensor)."""
    w, h = cfg.width, cfg.height
    sb = samples_per_batch
    if spp_chunk % sb != 0:
        raise ValueError(f"spp_chunk={spp_chunk} not divisible by "
                         f"samples_per_batch={sb}")
    dev = scene.geom.v0.device
    if key.device != dev:
        raise ValueError(f"the key is on {key.device}, the scene on {dev}")
    pixel_idx = _blocked_pixel_order(w, h, dev)

    fb = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    for bi in range(spp_chunk // sb):
        sids = sample_offset + bi * sb + torch.arange(sb, device=dev)
        pixel_idx_t, lkeys = sample_lane_keys(key, pixel_idx, sids)
        with telemetry.span("bdpt.batch"):
            fb_s, nr = render_sample(scene, cam_consts, cfg, key,
                                     pixel_idx_t, lkeys=lkeys)
        fb = fb + fb_s
        nrays = nrays + nr
    return fb, nrays


def render_image(scene, camera, cfg: BDPTConfig, seed: int = 0,
                 spp_chunk: int = 4, samples_per_batch: int = 1):
    """Host-side loop over spp chunks on the scene's device; returns
    the (H, W, 3) image and the total ray count."""
    device = scene.geom.v0.device
    cam_consts = camera.device_constants(device)
    fb = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                     device=device)
    total_rays = 0
    key = rng.key(seed, device)
    done = 0
    while done < cfg.spp:
        n = min(spp_chunk, cfg.spp - done)
        sb = samples_per_batch if n % samples_per_batch == 0 else 1
        fb_c, nr = render_chunk(scene, cam_consts, cfg, key, n,
                                sample_offset=done, samples_per_batch=sb)
        fb = fb + fb_c
        total_rays += int(nr)
        done += n
    return fb.reshape(cfg.height, cfg.width, 3), total_rays
