"""Vectorized BSDF layer: diffuse, perfect mirror, glass, Phong, mixture
(port of bpt_tpu/bsdf/bsdf.py).

All five models are evaluated as branch-free tensor math over a batch
of shading points and selected by the per-lane material `kind`.
Directions live in the local shading frame (+z = shading normal); `eval`
returns f * cos(theta_i); delta BSDFs return 0 from eval/pdf and do all
their work in `sample`, whose value is the importance weight f*cos/pdf.
Where the reference stops gradients, the port calls `.detach()`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import warp
from ..core.math import (
    INV_PI,
    INV_TWOPI,
    dot,
    frame_to_world,
    fresnel_dielectric,
    luminance,
    make_frame,
    reflect_local,
)
from ..ops.gather import gather_rows

# Material kinds (MTL illum map, reference: src/core/renderer.cpp:258-271).
DIFFUSE = 0   # illum 7
MIRROR = 1    # illum 3
GLASS = 2     # illum 6
PHONG = 3     # default
MIXTURE = 4   # illum 8


class MaterialTable(NamedTuple):
    """Per-material parameters, (M,)-leading tensors (raw MTL values)."""

    kind: torch.Tensor           # (M,) i32
    diffuse: torch.Tensor        # (M, 3) Kd
    specular: torch.Tensor       # (M, 3) Ks
    emission: torch.Tensor       # (M, 3) Ke
    shininess: torch.Tensor      # (M,)  Ns
    ior: torch.Tensor            # (M,)  Ni
    transmittance: torch.Tensor  # (M, 3) Tf


class LaneMaterial(NamedTuple):
    """Per-lane gathered material parameters + derived quantities."""

    kind: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    shininess: torch.Tensor
    ior: torch.Tensor
    transmittance: torch.Tensor
    scale: torch.Tensor        # energy-conservation scale (phong.h:40-43)
    spec_weight: torch.Tensor  # specular sampling weight (phong.h:45-47)


class BsdfSample(NamedTuple):
    wi: torch.Tensor      # (B, 3) local
    value: torch.Tensor   # (B, 3) f*cos/pdf
    pdf: torch.Tensor     # (B,)
    delta: torch.Tensor   # (B,) bool


def _zeros(x):
    return torch.zeros_like(x)


def gather_lane(mat: MaterialTable, mid, kd_override=None) -> LaneMaterial:
    """Gather per-lane materials; kd_override is the textured diffuse
    (scene/textures.py) replacing the constant Kd."""
    mid = mid.long()
    if kd_override is None:
        kd, ks, transmittance = gather_rows(
            (mat.diffuse, mat.specular, mat.transmittance), mid)
    else:
        kd = kd_override
        ks, transmittance = gather_rows((mat.specular, mat.transmittance), mid)
    max_v = torch.amax(kd + ks, dim=-1)
    scale = torch.where(max_v > 1.0, 0.99 / torch.clamp_min(max_v, 1e-12),
                        torch.ones_like(max_v))
    d_avg = luminance(kd * scale[..., None])
    s_avg = luminance(ks * scale[..., None])
    spec_weight = s_avg / torch.clamp_min(d_avg + s_avg, 1e-12)
    return LaneMaterial(
        kind=mat.kind[mid],
        kd=kd,
        ks=ks,
        shininess=mat.shininess[mid],
        ior=mat.ior[mid],
        transmittance=transmittance,
        scale=scale,
        spec_weight=spec_weight,
    )


def is_delta(lane: LaneMaterial):
    """EDelta lobe membership (reference: core.h:295)."""
    return (lane.kind == MIRROR) | (lane.kind == GLASS)


def emission(mat: MaterialTable, mid):
    """getEmission by material id (reference:
    src/core/integrator.cpp:41-44)."""
    return gather_rows((mat.emission,), mid)[0]


# ---------------------------------------------------------------------------
# eval / pdf
# ---------------------------------------------------------------------------

def _diffuse_eval(lane, wo, wi):
    """(reference: src/bsdfs/diffuse.h:35-43)"""
    gate = (wi[..., 2] >= 0.0) & (wo[..., 2] >= 0.0)
    val = lane.kd * INV_PI * wi[..., 2:3]
    return torch.where(gate[..., None], val, _zeros(val))


def _phong_like_eval(lane, wo, wi):
    """Shared by Phong and Mixture (reference: phong.h:61-76,
    mixture.h:60-76)."""
    gate = (wi[..., 2] >= 0.0) & (wo[..., 2] >= 0.0)
    cos_alpha = torch.clamp(dot(wi, reflect_local(wo)), 0.0, 1.0)
    n = lane.shininess
    spec = lane.ks * ((n + 2.0) * INV_TWOPI
                      * torch.pow(cos_alpha, n))[..., None]
    val = (lane.kd * INV_PI + spec) * (lane.scale * wi[..., 2])[..., None]
    return torch.where(gate[..., None], val, _zeros(val))


def _phong_pdf(lane, wo, wi):
    """Phong-lobe pdf of wi around reflect(wo) (reference: phong.h:78-88);
    dot(wi, reflect(wo)) is the z of wi in the lobe frame, and is
    symmetric in (wo, wi)."""
    cos_a = dot(wi, reflect_local(wo))
    n = lane.shininess
    val = (n + 2.0) * INV_TWOPI * torch.pow(torch.clamp_min(cos_a, 0.0), n)
    return torch.where(cos_a >= 0.0, val, _zeros(val))


def _mixture_pdf(lane, wo, wi, p_phong=None):
    """(reference: mixture.h:78-100)"""
    if p_phong is None:
        p_phong = _phong_pdf(lane, wo, wi)
    p_diff = warp.square_to_cosine_hemisphere_pdf(wi)
    w = lane.spec_weight
    return p_phong * w + p_diff * (1.0 - w)


def eval_lane(lane: LaneMaterial, wo, wi):
    """f * cos(theta_i); zero for delta BSDFs (reference:
    perfectmirror.h:33-39, glass.h:55-59)."""
    d = _diffuse_eval(lane, wo, wi)
    p = _phong_like_eval(lane, wo, wi)
    k = lane.kind[..., None]
    out = torch.where(k == DIFFUSE, d, _zeros(d))
    return torch.where((k == PHONG) | (k == MIXTURE), p, out)


def pdf_lane(lane: LaneMaterial, wo, wi):
    """Solid-angle pdf; zero for delta BSDFs (reference:
    perfectmirror.h:41-46, glass.h:61-65)."""
    d = warp.square_to_cosine_hemisphere_pdf(wi)
    ph = _phong_pdf(lane, wo, wi)
    mx = _mixture_pdf(lane, wo, wi, p_phong=ph)
    k = lane.kind
    out = torch.where(k == DIFFUSE, d, _zeros(d))
    out = torch.where(k == PHONG, ph, out)
    return torch.where(k == MIXTURE, mx, out)


def eval_pdfs_lane(lane: LaneMaterial, wo, wi):
    """Fused (eval_lane(wo, wi), pdf_lane(wo, wi), pdf_lane(wi, wo)): the
    phong-lobe power, symmetric in (wo, wi), is computed once.  This is
    the shading kernel of every BDPT connection."""
    k = lane.kind
    woz = wo[..., 2]
    wiz = wi[..., 2]
    gate = (wiz >= 0.0) & (woz >= 0.0)
    cos_a = dot(wi, reflect_local(wo))
    n = lane.shininess
    # eval uses the clipped power, the pdf gates on cos >= 0; they differ
    # only at n == 0.
    lobe = (n + 2.0) * INV_TWOPI * torch.pow(torch.clamp(cos_a, 0.0, 1.0), n)
    p_phong = torch.where(cos_a >= 0.0, lobe, _zeros(lobe))

    d_val = lane.kd * INV_PI * wi[..., 2:3]
    spec = lane.ks * lobe[..., None]
    p_val = (lane.kd * INV_PI + spec) * (lane.scale * wiz)[..., None]
    k3 = k[..., None]
    f = torch.where(k3 == DIFFUSE, d_val, _zeros(d_val))
    f = torch.where((k3 == PHONG) | (k3 == MIXTURE), p_val, f)
    f = torch.where(gate[..., None], f, _zeros(f))

    d_fwd = warp.square_to_cosine_hemisphere_pdf(wi)
    d_rev = warp.square_to_cosine_hemisphere_pdf(wo)
    w = lane.spec_weight

    def pick(d_pdf):
        out = torch.where(k == DIFFUSE, d_pdf, _zeros(d_pdf))
        out = torch.where(k == PHONG, p_phong, out)
        return torch.where(k == MIXTURE, p_phong * w + d_pdf * (1.0 - w),
                           out)

    return f, pick(d_fwd), pick(d_rev)


def eval_bsdf(mat: MaterialTable, mid, wo, wi, kd_override=None):
    """Gathering wrapper around eval_lane."""
    return eval_lane(gather_lane(mat, mid, kd_override), wo, wi)


def pdf_bsdf(mat: MaterialTable, mid, wo, wi, kd_override=None):
    """Gathering wrapper around pdf_lane."""
    return pdf_lane(gather_lane(mat, mid, kd_override), wo, wi)


# ---------------------------------------------------------------------------
# sample
# ---------------------------------------------------------------------------

def _glass_sample(lane, wo, u):
    """(reference: src/bsdfs/glass.h:67-108)"""
    woz = wo[..., 2]
    entering = woz > 0.0
    one = torch.ones_like(woz)
    eta_i = torch.where(entering, one, lane.ior)
    eta_t = torch.where(entering, lane.ior, one)
    eta = eta_i / eta_t
    sin2_i = torch.clamp_min(1.0 - woz * woz, 0.0)
    sin2_t = eta * eta * sin2_i
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    cos_t = torch.where(entering, -cos_t, cos_t)
    fr = fresnel_dielectric(eta_i, eta_t, torch.abs(woz), torch.abs(cos_t))
    reflect = u[..., 0] < fr
    wi_r = reflect_local(wo)
    wi_t = torch.stack([eta * -wo[..., 0], eta * -wo[..., 1], cos_t], dim=-1)
    wi = torch.where(reflect[..., None], wi_r, wi_t)
    val = torch.where(reflect[..., None], torch.ones_like(lane.transmittance),
                      lane.transmittance)
    return wi, val, torch.ones_like(fr)


def sample_bsdf(mat: MaterialTable, mid, wo, u2,
                kd_override=None) -> BsdfSample:
    """Gathering wrapper around sample_lane."""
    return sample_lane(gather_lane(mat, mid, kd_override), wo, u2)


def sample_lane(lane: LaneMaterial, wo, u2) -> BsdfSample:
    """Sample an outgoing direction for every lane from one shared 2D
    uniform per lane.  Sampled directions and pdfs are detached
    (detached-sampling estimator, see bpt_tpu/bsdf/bsdf.py)."""
    k = lane.kind

    # Diffuse (reference: diffuse.h:52-61).
    wi_d = warp.square_to_cosine_hemisphere(u2).detach()
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wi_d)
    val_d = _diffuse_eval(lane, wo, wi_d)

    # Mirror (reference: perfectmirror.h:49-59).
    wi_m = reflect_local(wo)
    val_m = torch.ones_like(wo)
    pdf_m = torch.ones_like(pdf_d)

    wi_g, val_g, pdf_g = _glass_sample(lane, wo, u2)

    # Phong (reference: phong.h:90-105): the specular lobe only.
    refl_frame = make_frame(reflect_local(wo))
    lobe = warp.square_to_phong_lobe(u2, lane.shininess).detach()
    pdf_p = warp.square_to_phong_lobe_pdf(lobe, lane.shininess.detach())
    wi_p = frame_to_world(refl_frame, lobe)
    val_p = _phong_like_eval(lane, wo, wi_p)

    # Mixture (reference: mixture.h:102-151): lobe by spec_weight with
    # sample reuse/rescale; pdf is the full mixture pdf.
    w = lane.spec_weight.detach()
    pick_spec = u2[..., 0] < w
    ux_spec = torch.clamp(u2[..., 0] / torch.clamp_min(w, 1e-12), 0.0, 1.0)
    ux_diff = torch.clamp(
        (u2[..., 0] - w) / torch.clamp_min(1.0 - w, 1e-12), 0.0, 1.0)
    u_spec = torch.stack([ux_spec, u2[..., 1]], dim=-1)
    u_diff = torch.stack([ux_diff, u2[..., 1]], dim=-1)
    lobe_mx = warp.square_to_phong_lobe(u_spec, lane.shininess).detach()
    wi_mx_spec = frame_to_world(refl_frame, lobe_mx)
    wi_mx_diff = warp.square_to_cosine_hemisphere(u_diff).detach()
    wi_mx = torch.where(pick_spec[..., None], wi_mx_spec, wi_mx_diff)
    pdf_mx = _mixture_pdf(lane, wo, wi_mx)
    val_mx = _phong_like_eval(lane, wo, wi_mx)

    def sel3(cond, a, b):
        return torch.where(cond[..., None], a, b)

    wi = sel3(k == DIFFUSE, wi_d, wi_p)
    wi = sel3(k == MIRROR, wi_m, wi)
    wi = sel3(k == GLASS, wi_g, wi)
    wi = sel3(k == MIXTURE, wi_mx, wi)

    val = sel3(k == DIFFUSE, val_d, val_p)
    val = sel3(k == MIRROR, val_m, val)
    val = sel3(k == GLASS, val_g, val)
    val = sel3(k == MIXTURE, val_mx, val)

    pdf = torch.where(k == DIFFUSE, pdf_d, pdf_p)
    pdf = torch.where(k == MIRROR, pdf_m, pdf)
    pdf = torch.where(k == GLASS, pdf_g, pdf)
    pdf = torch.where(k == MIXTURE, pdf_mx, pdf)

    return BsdfSample(wi=wi.detach(), value=val, pdf=pdf.detach(),
                      delta=is_delta(lane))
