"""Unidirectional path tracer, implicit and explicit (NEE + MIS) (port of
bpt_tpu/integrators/path.py).

The reference path tracer's estimators (reference:
src/integrators/path.h):

  * implicit: BSDF sampling only, with the one-sided emitter check
    `dot(ns, -wi) > 0` (path.h:35-64);
  * explicit: NEE with the balance heuristic over the emitter-area and
    BSDF strategies (path.h:116-195), the 0.95-probability re-roll of
    BSDF samples that land on an emitter (path.h:86-103, at most
    MAX_REROLLS tries), and Russian roulette when maxDepth == -1
    (path.h:73, 199-202);
  * a primary ray that hits an emitter returns Le (path.h:214-217,
    231-234).

Lanes are masked, never removed.  A trace carries only the lanes whose
hit is read (the others get max_t < min_t, which compaction packs away),
and the re-roll and bounce loops stop once no lane is left in them, at
one host sync each: the image and the ray count are those of the full
loops.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.api import trace_closest
from ..bsdf import bsdf
from ..core import rng
from ..core.camera import generate_rays
from ..core.math import (
    EPSILON,
    dot,
    frame_n,
    frame_to_local,
    frame_to_world,
    is_zero_rgb,
    length2,
    normalize,
)
from .common import (
    Interaction,
    emission_at,
    make_interaction,
    primary_trace,
    sample_emitter_position,
    sample_lane_keys,
    textured_kd,
)

# Bound on the reference's unbounded emitter re-roll loop (path.h:86-103);
# P(needing more) decays by 0.95 * P(hit emitter) per try.
MAX_REROLLS = 8


@dataclasses.dataclass(frozen=True)
class PathConfig:
    width: int
    height: int
    spp: int
    is_explicit: bool = True
    max_depth: int = -1       # -1 => Russian roulette mode (path.h:73)
    rr_depth: int = 5
    rr_prob: float = 0.95
    emitter_samples: int = 1
    bsdf_samples: int = 0
    max_bounces: int = 32     # hard cap for RR mode
    near: float = 1.0
    far: float = 1000.0

    @property
    def n_steps(self) -> int:
        if self.max_depth >= 0:
            return self.max_depth
        # maxDepth == -1: explicit mode switches to Russian roulette
        # (path.h:73); the implicit recursion has no RR path and
        # immediately returns black (path.h:36 `depth < -1`).
        return self.max_bounces if self.is_explicit else 0


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    """(reference: path.h:30-33)"""
    f = nf * f_pdf
    g = ng * g_pdf
    return f / torch.clamp_min(f + g, 1e-30)


def _where3(mask, a, b):
    return torch.where(mask[..., None], a, b)


def _trace_live(scene, o, d, live):
    """Closest hit of the rays (EPSILON, inf) on the `live` lanes; the
    others are dead lanes that miss."""
    inf = torch.full_like(o[..., 0], torch.inf)
    return trace_closest(scene, o, d, EPSILON,
                         torch.where(live, inf, torch.full_like(inf, -1.0)))


def _any_live(mask) -> bool:
    """Whether any lane of `mask` is set: one host sync."""
    return bool(mask.any())


def _direct_illumination(scene, cfg: PathConfig, lkeys, it, active,
                         kd_ov=None):
    """Direct-illumination estimator at one vertex: emitter-strategy and
    BSDF-strategy samples combined by the balance heuristic
    (reference: path.h:116-195).  Returns (B, 3)."""
    b = it.p.shape[0]
    dev = it.p.device
    total = torch.zeros((b, 3), dtype=torch.float32, device=dev)

    # --- emitter samples (path.h:121-154) ---
    em_est = torch.zeros_like(total)
    for i in range(cfg.emitter_samples):
        lk = rng.lane_fold(lkeys, 1000 + i)
        es = sample_emitter_position(scene, lk)
        wi_w = normalize(es.pos - it.p)
        wi_local = frame_to_local(it.frame_ns, wi_w)
        dist2 = torch.clamp_min(length2(es.pos - it.p), 1e-20)
        cos_out = dot(-wi_w, es.normal)
        ok = active & (cos_out > 0.0) & (wi_local[..., 2] > 0.0)

        # Visibility by closest hit + shape id match (path.h:134-150).
        hit = _trace_live(scene, it.p, wi_w, ok)
        hit_shape = scene.shape_id[hit.tri.clamp_min(0).long()]
        em_shape = scene.emitters.shape_id[es.em_id.long()]
        ok = ok & hit.valid & (hit_shape == em_shape)

        area_to_solid = cos_out / dist2
        safe_a2s = torch.where(ok, torch.clamp_min(area_to_solid, 1e-20),
                               torch.ones_like(area_to_solid))
        bsdf_pdf = bsdf.pdf_bsdf(scene.mat, it.mat_id, it.wo, wi_local,
                                 kd_ov)
        em_pdf_w = es.pos_pdf * es.select_pdf / safe_a2s
        weight = balance_heuristic(cfg.emitter_samples, em_pdf_w,
                                   cfg.bsdf_samples, bsdf_pdf)
        f = bsdf.eval_bsdf(scene.mat, it.mat_id, it.wo, wi_local, kd_ov)
        contrib = (weight[..., None] * es.radiance * f
                   * (safe_a2s / (es.pos_pdf * es.select_pdf))[..., None])
        em_est = em_est + _where3(ok, contrib, torch.zeros_like(contrib))
    if cfg.emitter_samples > 0:
        total = total + em_est / cfg.emitter_samples

    # --- BSDF samples (path.h:156-192) ---
    bs_est = torch.zeros_like(total)
    for i in range(cfg.bsdf_samples):
        lk = rng.lane_fold(lkeys, 2000 + i)
        u2 = rng.uniform2(rng.lane_fold(lk, rng.BSDF_SAMPLE))
        s = bsdf.sample_bsdf(scene.mat, it.mat_id, it.wo, u2, kd_ov)
        ok = active & ~is_zero_rgb(s.value)
        wi_w = frame_to_world(it.frame_ns, s.wi)
        hit = _trace_live(scene, it.p, wi_w, ok)
        it2 = make_interaction(scene, wi_w, hit)
        le = emission_at(scene, it2.mat_id)
        ok = ok & hit.valid & ~is_zero_rgb(le)

        em_id = torch.clamp_min(scene.shape_emitter[it2.shape_id.long()],
                                0).long()
        n_em = scene.emitters.radiance.shape[0]
        em_area_pdf = 1.0 / scene.emitters.area[em_id]
        em_pdf = 1.0 / n_em
        dist2 = torch.clamp_min(length2(it2.p - it.p), 1e-20)
        # Geometric-normal cosine (path.h:179 uses frameNg).
        cos_out = dot(-wi_w, it2.ng)
        ok = ok & (cos_out > 0.0)
        area_to_solid = torch.where(ok, torch.clamp_min(cos_out / dist2,
                                                        1e-20),
                                    torch.ones_like(cos_out))
        weight = balance_heuristic(cfg.bsdf_samples, s.pdf,
                                   cfg.emitter_samples,
                                   em_pdf * em_area_pdf / area_to_solid)
        safe_pdf = torch.where(s.pdf > 0, s.pdf, torch.ones_like(s.pdf))
        contrib = weight[..., None] * le * s.value / safe_pdf[..., None]
        bs_est = bs_est + _where3(ok, contrib, torch.zeros_like(contrib))
    if cfg.bsdf_samples > 0:
        total = total + bs_est / cfg.bsdf_samples

    return total


def _pack_it(p, wo, frame, mid, tri, u, v):
    """Interaction view of a walk vertex: the fields the estimators read,
    `ng` the shading frame's normal row, `shape_id` zeros."""
    b = p.shape[0]
    z = torch.zeros((b,), dtype=torch.float32, device=p.device)
    return Interaction(
        p=p, t=z, u=u, v=v, tri=tri, mat_id=mid,
        shape_id=torch.zeros((b,), dtype=torch.int32, device=p.device),
        frame_ns=frame, ng=frame[..., 2, :], wo=wo,
        valid=torch.ones((b,), dtype=torch.bool, device=p.device))


def _select_it(take, new, old):
    """Per-lane choice between two Interactions."""
    return Interaction._make(
        torch.where(take.reshape(take.shape + (1,) * (a.ndim - 1)), b, a)
        for a, b in zip(old, new))


def _reroll(scene, it_cur, kd_ov, alive, kd):
    """Sample the BSDF for the next bounce, re-rolling samples that hit an
    emitter with probability 0.95, at most MAX_REROLLS tries (path.h:
    86-103).  Returns (next vertex, value, pdf, still re-rolling, tries
    taken)."""
    b = alive.shape[0]
    best_it = it_cur
    best_val = torch.zeros((b, 3), dtype=torch.float32, device=alive.device)
    best_pdf = torch.ones((b,), dtype=torch.float32, device=alive.device)
    need = alive
    n_used = torch.zeros((b,), dtype=torch.int32, device=alive.device)
    rngk = rng.lane_fold(kd, 3000)
    for i in range(MAX_REROLLS):
        if i and not _any_live(need):
            break
        rki = rng.lane_fold(rngk, i)
        u2 = rng.uniform2(rng.lane_fold(rki, rng.BSDF_SAMPLE))
        s = bsdf.sample_bsdf(scene.mat, it_cur.mat_id, it_cur.wo, u2, kd_ov)
        wi_w = frame_to_world(it_cur.frame_ns, s.wi)
        h2 = _trace_live(scene, it_cur.p, wi_w, need)
        it2 = make_interaction(scene, wi_w, h2)
        hit_emitter = h2.valid & ~is_zero_rgb(emission_at(scene, it2.mat_id))
        best_it = _select_it(need, it2, best_it)
        best_val = _where3(need, s.value, best_val)
        best_pdf = torch.where(need, s.pdf, best_pdf)
        n_used = n_used + need.to(torch.int32)
        u_re = rng.uniform1(rng.lane_fold(rki, rng.RR))
        need = need & hit_emitter & (u_re < 0.95)
    return best_it, best_val, best_pdf, need, n_used


def render_sample_path(scene, cam_consts, cfg: PathConfig, key, pixel_idx,
                       lkeys=None):
    """One explicit or implicit path-traced sample per pixel lane.

    lkeys: optional (B, 2) lane keys (several samples batched, see
    render_chunk_path); without them lanes are keyed by pixel,
    rng.lane_keys(key, pixel_idx).
    Returns (framebuffer contribution (W*H, 3), ray count 0-dim int64)."""
    b = pixel_idx.shape[0]
    w, h = cfg.width, cfg.height
    if lkeys is None:
        lkeys = rng.lane_keys(key, pixel_idx)

    jitter = None
    if cfg.spp > 1:
        jitter = rng.uniform2(rng.lane_fold(lkeys, rng.PIXEL_JITTER))
    o, d = generate_rays(cam_consts, w, h, pixel_idx, jitter)

    hit, it = primary_trace(scene, o, d, cfg.near, cfg.far)
    nrays = torch.full((), b, dtype=torch.int64, device=d.device)

    le0 = emission_at(scene, it.mat_id)
    primary_emitter = hit.valid & ~is_zero_rgb(le0)
    # Primary emitter hit: return Le (path.h:214-217, 231-234).
    li = _where3(primary_emitter, le0, torch.zeros_like(le0))

    alive = hit.valid & ~primary_emitter
    throughput = torch.ones((b, 3), dtype=torch.float32, device=d.device)
    it_cur = _pack_it(it.p, it.wo, it.frame_ns, it.mat_id, it.tri, it.u,
                      it.v)
    lk_eye = rng.lane_fold(lkeys, rng.EYE_WALK)
    for depth in range(cfg.n_steps):
        if depth and not _any_live(alive):
            break
        kd = rng.lane_fold(lk_eye, depth)

        # Depth/RR continuation (path.h:73, 199-202).
        rr_scale = 1.0
        if cfg.max_depth == -1 and depth >= cfg.rr_depth:
            u_rr = rng.uniform1(rng.lane_fold(kd, rng.RR))
            alive = alive & (u_rr < cfg.rr_prob)
            rr_scale = 1.0 / cfg.rr_prob

        kd_ov = textured_kd(scene, it_cur)
        if cfg.is_explicit:
            direct = _direct_illumination(scene, cfg, kd, it_cur, alive,
                                          kd_ov)
            nrays = nrays + alive.sum() * (cfg.emitter_samples
                                           + cfg.bsdf_samples)
            li = li + throughput * rr_scale * direct

            # Indirect: the BSDF sample, re-rolled off emitters.
            it2, val, pdf, still, n_used = _reroll(scene, it_cur, kd_ov,
                                                   alive, kd)
            nrays = nrays + n_used.sum()
            le2 = emission_at(scene, it2.mat_id)
            ok_ind = (alive & it2.valid & is_zero_rgb(le2)
                      & ~is_zero_rgb(val) & ~still)
            cum_rr = torch.where(n_used > 1, 0.95, 1.0)
            safe_pdf = torch.where(pdf > 0, pdf, torch.ones_like(pdf))
            scale = (val / safe_pdf[..., None]
                     / torch.clamp_min(n_used, 1)[..., None]
                     / cum_rr[..., None])
            throughput = _where3(ok_ind, throughput * rr_scale * scale,
                                 throughput)
            alive = alive & ok_ind
        else:
            # Implicit recursion (path.h:35-64).
            u2 = rng.uniform2(rng.lane_fold(kd, rng.BSDF_SAMPLE))
            s = bsdf.sample_bsdf(scene.mat, it_cur.mat_id, it_cur.wo, u2,
                                 kd_ov)
            wi_w = frame_to_world(it_cur.frame_ns, s.wi)
            h2 = _trace_live(scene, it_cur.p, wi_w, alive)
            nrays = nrays + alive.sum()
            it2 = make_interaction(scene, wi_w, h2)
            le = emission_at(scene, it2.mat_id)
            safe_pdf = torch.where(s.pdf > 0, s.pdf, torch.ones_like(s.pdf))
            factor = s.value / safe_pdf[..., None]
            hit_emitter = h2.valid & ~is_zero_rgb(le)
            # One-sided emitter (path.h:53).
            facing = dot(frame_n(it2.frame_ns), -wi_w) > 0.0
            contrib = throughput * factor * le
            li = li + _where3(alive & hit_emitter & facing, contrib,
                              torch.zeros_like(contrib))
            throughput = _where3(alive, throughput * factor, throughput)
            alive = alive & h2.valid & ~hit_emitter & ~is_zero_rgb(s.value)
        it_cur = _pack_it(it2.p, it2.wo, it2.frame_ns, it2.mat_id, it2.tri,
                          it2.u, it2.v)

    fb = torch.zeros((w * h, 3), dtype=torch.float32, device=d.device)
    fb.index_add_(0, pixel_idx.long(), li / cfg.spp)
    return fb, nrays


def render_chunk_path(scene, cam_consts, cfg: PathConfig, key,
                      spp_chunk: int = 1, sample_offset: int = 0,
                      samples_per_batch: int = 1):
    """`spp_chunk` full-image samples into one framebuffer, keyed
    fold_in(key, sample_offset + s) per sample and by pixel per lane, so
    the estimate does not depend on chunking or on samples_per_batch
    (samples fused into one batch of sb * W * H lanes).  The buffer is
    already divided by cfg.spp.
    Returns (fb (W*H, 3), nrays 0-dim int64 tensor)."""
    sb = samples_per_batch
    if spp_chunk % sb != 0:
        raise ValueError(f"spp_chunk={spp_chunk} not divisible by "
                         f"samples_per_batch={sb}")
    dev = scene.geom.v0.device
    if key.device != dev:
        raise ValueError(f"the key is on {key.device}, the scene on {dev}")
    pixel_idx = torch.arange(cfg.width * cfg.height, dtype=torch.int32,
                             device=dev)
    fb = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                     device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    for bi in range(spp_chunk // sb):
        sids = sample_offset + bi * sb + torch.arange(sb, device=dev)
        pix, lkeys = sample_lane_keys(key, pixel_idx, sids)
        fb_s, nr = render_sample_path(scene, cam_consts, cfg, key, pix,
                                      lkeys=lkeys)
        fb = fb + fb_s
        nrays = nrays + nr
    return fb, nrays


def render_image_path(scene, camera, cfg: PathConfig, seed: int = 0,
                      spp_chunk: int = 4):
    """Host loop over spp chunks on the scene's device; returns the
    (H, W, 3) image and the total ray count."""
    device = scene.geom.v0.device
    cam_consts = camera.device_constants(device)
    fb = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                     device=device)
    total_rays = 0
    key = rng.key(seed, device)
    done = 0
    while done < cfg.spp:
        n = min(spp_chunk, cfg.spp - done)
        fb_c, nr = render_chunk_path(scene, cam_consts, cfg, key, n,
                                     sample_offset=done)
        fb = fb + fb_c
        total_rays += int(nr)
        done += n
    return fb.reshape(cfg.height, cfg.width, 3), total_rays
