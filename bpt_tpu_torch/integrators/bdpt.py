"""Bidirectional path tracer with VCM-style recursive MIS weights: the
main path of the reference package's bpt_tpu/integrators/bdpt.py.

What is ported is the path `render_chunk` takes in BDPT mode with
mega-connect and fused walks (the reference package's defaults):

  1. camera rays and one closest-hit trace of the primaries;
  2. `fused_subpath_walks`: per depth, one closest-hit trace over the eye
     and light bounce rays together (2B lanes), BSDF sampling and the
     vc/vcm MIS updates, with every visibility test deferred;
  3. `_mega_connect`: one any-hit trace over every connection segment of
     the sample (NEE, t=1 camera splats and the L x L eye x light pair
     grid), then the MIS-weighted sums;
  4. two scatter-adds into the framebuffer.

`lax.scan` over depths is a Python loop; the reference's quirks (NO_RR
depth bound, 1/(W*H) light-path counting, the s=0 position pdf) are kept
verbatim, see bpt_tpu/integrators/bdpt.py.  Configurations outside this
slice (other modes, Russian roulette, pooled light transport, a pair
grid beyond the lane budget, rr_depth < 2) raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

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
    make_frame,
)
from ..scene.textures import albedo_at
from . import mis as mis_fn
from .common import (
    emission_at,
    make_interaction,
    sample_emitter_position,
    textured_kd,
)

# Lane budget of the unchunked L x L x B pair grid of `_mega_connect`
# (the reference package's _MEGA_MAX_LANES default).
MEGA_MAX_LANES = 8 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class BDPTConfig:
    """Render configuration: the reference package's fields that the
    slice runs; `mode`, `no_rr` and `light_pool` exist so that
    `check_slice` can refuse the values it does not run."""

    width: int
    height: int
    spp: int
    rr_depth: int = 5
    mode: str = "bdpt"
    no_rr: bool = True
    near: float = 1.0
    far: float = 1000.0
    light_pool: int = 0

    @property
    def n_steps(self) -> int:
        """Walk iterations: depth runs 1..rr_depth-1 in NO_RR mode
        (bdpt.h:68,188)."""
        return max(self.rr_depth - 1, 0)


def check_slice(cfg: BDPTConfig, lanes: int):
    """Raise NotImplementedError for configurations this port does not
    run yet (they never fall back to another path)."""
    if cfg.mode != "bdpt":
        raise NotImplementedError(f"mode={cfg.mode!r}: only 'bdpt' is ported")
    if not cfg.no_rr:
        raise NotImplementedError("Russian-roulette walks (no_rr=False)")
    if cfg.light_pool > 0:
        raise NotImplementedError("pooled light transport (light_pool > 0)")
    l = cfg.n_steps
    if l == 0:
        raise NotImplementedError("rr_depth < 2 (no walk steps)")
    if l * l * lanes > MEGA_MAX_LANES:
        raise NotImplementedError(
            f"pair grid of {l * l * lanes} lanes exceeds {MEGA_MAX_LANES} "
            "(the chunked pair connect)")


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


def _rr_probability(throughput):
    """Continuation probability for the next bounce: 1 in NO_RR mode
    (reference: bdpt.h:129-132, 201-204)."""
    return torch.ones(throughput.shape[:-1], dtype=torch.float32,
                      device=throughput.device)


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


def _visible(scene, start, end, needed=None):
    """visibilityQuery: True where the segment is OCCLUDED
    (reference: bdpt.h:498-514), ray [EPSILON, dist - VIS_SHORTEN].
    Lanes with needed=False are traced as degenerate segments."""
    seg = end - start
    dist = length(seg)
    d = seg / torch.clamp_min(dist, 1e-20)[..., None]
    del seg  # the 8.3M-lane mega batch: free each column once consumed
    max_t = dist - VIS_SHORTEN
    if needed is not None:
        max_t = torch.where(needed, max_t, torch.full_like(max_t, -1.0))
    return trace_any(scene, start, d, EPSILON, max_t)


def _connect_to_camera(cam_consts, cfg: BDPTConfig, it, lane, throughput,
                       vcm, vc, rr_prob, active):
    """t=1: splat a light vertex onto the image plane (reference:
    bdpt.h:295-371, VCM Eqs. 46-47), visibility deferred.  Returns
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

    n_light = float(w * h)
    safe_z = torch.where(ok, torch.clamp_min(wi_local[..., 2], 1e-20), one)
    radiance = (throughput * f * (1.0 / safe_z)[..., None]
                * image_to_surf[..., None] * (1.0 / (n_light * cfg.spp)))

    prev_rev_pdf = prev_rev * rr_prob
    mis = mis_fn.weight_t1(image_to_surf, n_light, prev_rev_pdf, vc,
                           vcm).detach()
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
    with li weighted but not occlusion-masked."""
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

    light_rev_pdf_w = pdf_f * rr_prob
    eye_prev_rev_pdf_w = pdf_r * rr_prob
    eye_cur_rev_pdf_a = cos_at_eye / dist2 * dir_pdf_w
    mis = mis_fn.weight_s1(
        light_rev_pdf_w, torch.clamp_min(connect_pdf_w, 1e-30),
        eye_cur_rev_pdf_a, eye_prev_rev_pdf_w, vc, vcm).detach()
    li = li * mis[..., None]
    return torch.where(ok[..., None], li, torch.zeros_like(li)), ok, es.pos


def _connect_vertices(lv_p, lv_frame, lv_wo, lv_thr, lv_vcm, lv_vc, lv_rr,
                      lv_lane, lv_valid, eye_p, eye_frame, eye_wo, eye_lane,
                      throughput, vcm, vc, rr_prob, active):
    """s>=2, t>=2 deterministic connection (reference: bdpt.h:434-483,
    VCM Eqs. 40-41), visibility deferred.  Light- and eye-side arguments
    broadcast against each other (the pair grid passes (1, L, B, ...)
    light arrays and (L, 1, B, ...) eye arrays).  Returns (li (...,3),
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
    mis = mis_fn.weight_connect(light_rev_a, pdf_l_prev, lv_vc, lv_vcm,
                                eye_rev_a, pdf_e_prev, vc, vcm).detach()
    li = li * mis[..., None]
    return torch.where(ok[..., None], li, torch.zeros_like(li)), ok


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


def _light_pre(carry):
    """Light-walk step, ray-build half.  Dead lanes trace degenerate rays
    (max_t < min_t)."""
    o, d, throughput, vc, vcm, alive, rr_prev, nrays = carry
    nrays = nrays + alive.sum()
    max_t = torch.where(alive, torch.inf, -1.0).to(torch.float32)
    return (o, d, throughput, vc, vcm, alive, rr_prev, nrays), (
        o, d, EPSILON, max_t)


def _light_post(scene, cam_consts, cfg: BDPTConfig, lk, carry, depth, hit):
    """Light-walk step, hit-consume half (reference: bdpt.h:186-215),
    with the t=1 occlusion deferred to the mega-connect batch."""
    o, d, throughput, vc, vcm, alive, rr_prev, nrays = carry
    kd = rng.lane_fold(lk, depth)

    alive = alive & hit.valid
    it = make_interaction(scene, d, hit)

    dist2 = hit.t * hit.t
    abs_cos_in = torch.clamp_min(torch.abs(it.wo[..., 2]), 1e-20)
    # Freeze dead lanes' MIS state (it could overflow across steps).
    vc_u, vcm_u = mis_fn.measure_update(vc, vcm, dist2, abs_cos_in)
    vcm = torch.where(alive, vcm_u, vcm)
    vc = torch.where(alive, vc_u, vc)

    rr_prob = _rr_probability(throughput)
    lane = bsdf.gather_lane(scene.mat, it.mat_id, textured_kd(scene, it))
    delta = bsdf.is_delta(lane)

    pix, rgb, okc = _connect_to_camera(
        cam_consts, cfg, it, lane, throughput, vcm, vc, rr_prob,
        alive & ~delta)

    o2, d2, thr2, vc2, vcm2, alive2, _ = _continue_walk(
        kd, it, lane, rr_prob, throughput, vc, vcm, alive)
    vertex_valid = alive & ~delta & alive2  # push-after-continue,
    # reference bdpt.h:211-215

    vertex = LightVertexSlots(
        p=it.p, ns=it.frame_ns[..., 2, :], wo=it.wo, throughput=throughput,
        vcm=vcm, vc=vc, rr=rr_prob, mat_id=it.mat_id, tri=it.tri, u=it.u,
        v=it.v, valid=vertex_valid)
    return (o2, d2, thr2, vc2, vcm2, alive2, rr_prob, nrays), (
        vertex, pix, rgb, okc)


def _eye_pre(cfg: BDPTConfig, carry, depth):
    """Eye-walk step, ray-build half.  Primary rays carry the [near, far]
    window (renderer.cpp:177,192); bounce rays are unbounded; dead lanes
    trace degenerate rays."""
    (o, d, throughput, vc, vcm, alive, rr_prev, pure_spec, li,
     nrays) = carry
    nrays = nrays + alive.sum()
    min_t = cfg.near if depth == 1 else EPSILON
    max_t = cfg.far if depth == 1 else torch.inf
    carry = (o, d, throughput, vc, vcm, alive, rr_prev, pure_spec, li,
             nrays)
    return carry, (o, d, min_t,
                   torch.where(alive, max_t, -1.0).to(torch.float32))


def _eye_post(scene, cfg: BDPTConfig, lk_eye, carry, depth, hit):
    """Eye-walk step, hit-consume half (reference: bdpt.h:68-152), with
    every connection's visibility deferred: NEE is shaded here and its
    segments returned; the s>=2 pairs are left to `_mega_connect`."""
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
    em_id = torch.clamp_min(scene.shape_emitter[it.shape_id.long()],
                            0).long()
    em_area = scene.emitters.area[em_id]
    emitter_pdf = 1.0 / n_emitters
    # Replicated verbatim: 1/(area*emitterPdf) (bdpt.h:87).
    pos_pdf_a = 1.0 / (em_area * emitter_pdf)
    mis_s0 = mis_fn.weight_s0(pos_pdf_a, INV_TWOPI, vc, vcm).detach()

    contrib = scene.emitters.radiance[em_id] * throughput
    contrib = contrib * torch.where(pure_spec, torch.ones_like(mis_s0),
                                    mis_s0)[..., None]
    zero3 = torch.zeros_like(contrib)
    if depth > 1:
        li = li + torch.where(hit_emitter[..., None], contrib, zero3)
    else:
        li = li + torch.where(hit_emitter[..., None], le, zero3)
    alive = alive & ~hit_emitter  # break (bdpt.h:124)

    rr_prob = _rr_probability(throughput)
    lane = bsdf.gather_lane(scene.mat, it.mat_id, textured_kd(scene, it))
    delta = bsdf.is_delta(lane)
    connectable = alive & ~delta
    pure_spec = pure_spec & ~connectable  # bdpt.h:139

    # ---- s=1 NEE (bdpt.h:142), occlusion deferred ----
    nee = _connect_to_light(scene, cfg, kd, it, lane, throughput, vcm, vc,
                            rr_prob, connectable)

    o2, d2, thr2, vc2, vcm2, alive2, _ = _continue_walk(
        kd, it, lane, rr_prob, throughput, vc, vcm, alive)
    # The eye vertex as the s>=2 connection uses it at THIS depth
    # (pre-continue state, bdpt.h:142-152).
    vertex = LightVertexSlots(
        p=it.p, ns=it.frame_ns[..., 2, :], wo=it.wo, throughput=throughput,
        vcm=vcm, vc=vc, rr=rr_prob, mat_id=it.mat_id, tri=it.tri, u=it.u,
        v=it.v, valid=connectable)
    return (o2, d2, thr2, vc2, vcm2, alive2, rr_prob, pure_spec, li,
            nrays), (vertex, nee)


def fused_subpath_walks(scene, cam_consts, cfg: BDPTConfig, lkeys, b,
                        primary_d, primary_alive):
    """Both subpath walks in one loop over depths, visibility fully
    deferred: each depth runs ONE closest-hit trace over the 2B eye and
    light bounce rays.

    Returns (light_slots, t1_pix, t1_rgb, t1_ok, li_s0, eye_slots,
    (nee_li, nee_ok, nee_end), nrays), per-depth arrays stacked (L, B)."""
    l = cfg.n_steps
    n_light = float(cfg.width * cfg.height)
    lk_l, lc = _light_walk_init(scene, lkeys, b, primary_alive)
    lk_e = rng.lane_fold(lkeys, rng.EYE_WALK)

    dev = primary_d.device
    cos_cam = dot(cam_consts["forward"], primary_d)
    img_pt_dist = cam_consts["vnpd"] / torch.clamp_min(cos_cam, 1e-20)
    t1_pdf = img_pt_dist * img_pt_dist / torch.clamp_min(cos_cam, 1e-20)
    vc_e, vcm_e = mis_fn.eye_walk_init(n_light, t1_pdf)
    ec = (cam_consts["o"].expand(primary_d.shape), primary_d,
          torch.ones((b, 3), dtype=torch.float32, device=dev), vc_e, vcm_e,
          torch.ones((b,), dtype=torch.bool, device=dev),
          torch.ones((b,), dtype=torch.float32, device=dev),
          torch.ones((b,), dtype=torch.bool, device=dev),
          torch.zeros((b, 3), dtype=torch.float32, device=dev),
          torch.zeros((), dtype=torch.int64, device=dev))

    eye_ys, light_ys = [], []
    for depth in range(1, l + 1):
        ec, (eo, ed, emn, emx) = _eye_pre(cfg, ec, depth)
        lc, (lo, ld, lmn, lmx) = _light_pre(lc)
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
        ec, eys = _eye_post(scene, cfg, lk_e, ec, depth, eh)
        lc, lys = _light_post(scene, cam_consts, cfg, lk_l, lc, depth, lh)
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


def _lane_view(lane, shape):
    """Reshape every field of a LaneMaterial gathered over L*B lanes to
    `shape` + its trailing dims."""
    return type(lane)(*(a.reshape(shape + a.shape[1:]) for a in lane))


def _mega_connect(scene, cam_consts, cfg: BDPTConfig,
                  eye_slots: LightVertexSlots,
                  light_slots: LightVertexSlots,
                  nee_li, nee_ok, nee_end, t1_pix, t1_rgb, t1_ok):
    """Resolve every connection segment of one sample in ONE any-hit
    trace: s=1 NEE (L*B), t=1 camera splats (L*B) and the s>=2 pair grid
    (L*L*B per-pixel eye-depth x light-slot pairs, the reference's nested
    loop bdpt.h:145-149).

    The pair grid is shaded by broadcasting (L, 1, B) eye arrays against
    (1, L, B) light arrays, so only the per-pair results are L*L*B wide;
    the segment endpoints are materialised for the trace.

    Returns (li_connect (B,3), splat_pix (L*B,), splat_rgb (L*B,3),
    n_vis_rays)."""
    l, b = eye_slots.valid.shape
    lb = l * b
    llb = l * lb
    wh = cfg.width * cfg.height

    lv_kd = albedo_at(scene, light_slots.tri.reshape(lb),
                      light_slots.u.reshape(lb), light_slots.v.reshape(lb))
    lv_lane = _lane_view(bsdf.gather_lane(
        scene.mat, light_slots.mat_id.reshape(lb), lv_kd), (1, l, b))
    eye_kd = albedo_at(scene, eye_slots.tri.reshape(lb),
                       eye_slots.u.reshape(lb), eye_slots.v.reshape(lb))
    eye_lane = _lane_view(bsdf.gather_lane(
        scene.mat, eye_slots.mat_id.reshape(lb), eye_kd), (l, 1, b))

    def ls(a):  # light side: repeats along the eye-depth axis
        return a[None]

    def es(a):  # eye side: repeats along the light-slot axis
        return a[:, None]

    c_li, c_ok = _connect_vertices(
        ls(light_slots.p), ls(make_frame(light_slots.ns)),
        ls(light_slots.wo), ls(light_slots.throughput),
        ls(light_slots.vcm), ls(light_slots.vc), ls(light_slots.rr),
        lv_lane, ls(light_slots.valid),
        es(eye_slots.p), es(make_frame(eye_slots.ns)), es(eye_slots.wo),
        eye_lane, es(eye_slots.throughput), es(eye_slots.vcm),
        es(eye_slots.vc), es(eye_slots.rr), es(eye_slots.valid))
    del lv_lane, eye_lane

    # Segments in the order NEE (L*B), t=1 (L*B), pairs (L*L*B).
    ok_all = torch.cat([nee_ok.reshape(lb), t1_ok.reshape(lb),
                        c_ok.reshape(llb)])
    start_all = torch.cat([
        eye_slots.p.reshape(lb, 3), cam_consts["o"].expand(lb, 3),
        es(eye_slots.p).expand(l, l, b, 3).reshape(llb, 3)])
    end_all = torch.cat([
        nee_end.reshape(lb, 3), light_slots.p.reshape(lb, 3),
        ls(light_slots.p).expand(l, l, b, 3).reshape(llb, 3)])
    occ = _visible(scene, start_all, end_all, needed=ok_all)
    del start_all, end_all  # the 8.3M-lane endpoints are no longer needed
    vis = ~occ
    nrays = ok_all.sum()

    li = torch.where(vis[:lb].reshape(l, b, 1), nee_li,
                     torch.zeros_like(nee_li)).sum(dim=0)
    ok2 = t1_ok.reshape(lb) & vis[lb:2 * lb]
    t1_pix = torch.where(ok2, t1_pix.reshape(lb),
                         torch.full((lb,), wh, dtype=t1_pix.dtype,
                                    device=t1_pix.device))
    t1_rgb = torch.where(ok2[..., None], t1_rgb.reshape(lb, 3),
                         torch.zeros((lb, 3), dtype=t1_rgb.dtype,
                                     device=t1_rgb.device))
    c = torch.where(vis[2 * lb:].reshape(l, l, b, 1), c_li,
                    torch.zeros_like(c_li))
    li = li + c.sum(dim=(0, 1))
    return li, t1_pix, t1_rgb, nrays


def render_sample(scene, cam_consts, cfg: BDPTConfig, pixel_idx, lkeys):
    """One pixel-sample per lane -> dense (W*H, 3) framebuffer increment
    (eye contributions at their pixel, light splats anywhere) and the ray
    count.  lkeys: (B, 2) per-(pixel, sample) lane keys."""
    b = pixel_idx.shape[0]
    w, h = cfg.width, cfg.height
    check_slice(cfg, b)

    jitter = None
    if cfg.spp > 1:
        jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    o, d = generate_rays(cam_consts, w, h, pixel_idx, jitter)

    primary_hit = trace_closest(scene, o, d, cfg.near, cfg.far)
    primary_alive = primary_hit.valid
    nrays = torch.full((), b, dtype=torch.int64, device=d.device)

    (slots, t1_pix, t1_rgb, t1_ok, li, eye_slots,
     (nee_li, nee_ok, nee_end), nr_w) = fused_subpath_walks(
        scene, cam_consts, cfg, lkeys, b, d, primary_alive)
    nrays = nrays + nr_w
    li_c, splat_pix, splat_rgb, nr_c = _mega_connect(
        scene, cam_consts, cfg, eye_slots, slots, nee_li, nee_ok, nee_end,
        t1_pix, t1_rgb, t1_ok)
    nrays = nrays + nr_c
    li = torch.where(primary_alive[..., None], li + li_c,
                     torch.zeros_like(li))

    # index_add_ on CUDA accumulates with atomics in run-dependent order.
    fb = torch.zeros((w * h + 1, 3), dtype=torch.float32, device=d.device)
    fb.index_add_(0, pixel_idx.long(), li / cfg.spp)
    fb.index_add_(0, splat_pix.long(), splat_rgb)
    return fb[: w * h], nrays


def _blocked_pixel_order(w: int, h: int, device, bs: int = 16):
    """Pixel ids ordered by bs x bs screen blocks, so consecutive lanes
    (and their bounce rays and segments) stay spatially coherent."""
    idx = torch.arange(w * h, dtype=torch.int32, device=device)
    if w % bs or h % bs:
        return idx
    idx = idx.reshape(h // bs, bs, w // bs, bs)
    return idx.permute(0, 2, 1, 3).reshape(-1)


def render_chunk(scene, cam_consts, cfg: BDPTConfig, key, spp_chunk: int = 1,
                 sample_offset: int = 0, samples_per_batch: int = 1):
    """Render `spp_chunk` full-image samples into one framebuffer.

    Sample s is keyed fold_in(key, sample_offset + s) and every lane by
    its pixel, so the estimate does not depend on chunking or on
    samples_per_batch (samples fused into one wavefront batch of
    sb * W * H lanes).  The buffer is already divided by cfg.spp.
    Returns (fb (W*H, 3), nrays 0-dim int64 tensor)."""
    w, h = cfg.width, cfg.height
    sb = samples_per_batch
    if spp_chunk % sb != 0:
        raise ValueError(f"spp_chunk={spp_chunk} not divisible by "
                         f"samples_per_batch={sb}")
    dev = key.device
    pixel_idx = _blocked_pixel_order(w, h, dev)
    # Pixel-major interleave (p0s0, p0s1, ..., p1s0, ...).
    pixel_idx_t = pixel_idx.repeat_interleave(sb)

    fb = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    for bi in range(spp_chunk // sb):
        sids = sample_offset + bi * sb + torch.arange(sb, device=dev)
        skeys = rng.fold_in(key[None, :], sids)                   # (sb, 2)
        lkeys = rng.fold_in(skeys[:, None, :], pixel_idx[None, :])
        lkeys = lkeys.transpose(0, 1).reshape(sb * w * h, 2)    # pixel-major
        fb_s, nr = render_sample(scene, cam_consts, cfg, pixel_idx_t, lkeys)
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
