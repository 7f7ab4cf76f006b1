"""VCM-style recursive MIS bookkeeping as pure functions (port of
bpt_tpu/integrators/mis.py; Georgiev, "Implementing Vertex Connection and
Merging", 2012; reference: src/integrators/bdpt.h:274-285, 335-353,
426-479).

vcm, vc are the partial MIS sums carried along a walk; `*_pdf_w` are
solid-angle pdfs and `*_pdf_a` area pdfs, with RR factors already folded
in by the callers; weights are the balance heuristic evaluated
recursively.  A NaN sum (0 * inf) counts as an infinite competing weight,
as in the reference package.
"""
from __future__ import annotations

import torch

__all__ = [
    "light_walk_init",
    "eye_walk_init",
    "measure_update",
    "bounce_update",
    "weight_s0",
    "weight_s1",
    "weight_connect",
    "weight_t1",
]


def _nan_inf(x):
    """NaN -> +inf and +-inf -> the largest finite values, as
    `jnp.nan_to_num(x, nan=jnp.inf)` maps them."""
    return torch.nan_to_num(x, nan=float("inf"))


def light_walk_init(cos_out, emission_pdf, area_pdf):
    """vc/vcm after sampling the emitter position + direction
    (reference: bdpt.h:173-177)."""
    vc = cos_out / emission_pdf
    vcm = area_pdf / emission_pdf
    return vc, vcm


def eye_walk_init(n_light, t1_pdf):
    """vc/vcm after the camera samples the primary ray
    (reference: bdpt.h:49-62)."""
    vc = torch.zeros_like(t1_pdf)
    vcm = n_light * (1.0 / t1_pdf)
    return vc, vcm


def measure_update(vc, vcm, dist2, abs_cos_in):
    """Solid-angle -> area jacobians at each new hit
    (reference: bdpt.h:196-197, 76-77)."""
    return vc / abs_cos_in, vcm * dist2 / abs_cos_in


def bounce_update(vc, vcm, abs_cos_out, pdf_w, prev_rev_pdf_w, delta):
    """vc/vcm recursion across a BSDF bounce (reference: bdpt.h:274-285;
    delta case Georgiev Eqs. 53-54)."""
    ratio = abs_cos_out / pdf_w
    vc_delta = ratio * (prev_rev_pdf_w * vc)
    vc_smooth = ratio * (vcm + prev_rev_pdf_w * vc)
    vc = torch.where(delta, vc_delta, vc_smooth)
    inv = 1.0 / pdf_w
    vcm = torch.where(delta, torch.zeros_like(inv), inv)
    return vc, vcm


def weight_s0(pos_pdf_a, dir_pdf_w, vc, vcm):
    """s=0: the eye path hit the emitter (reference: bdpt.h:83-118)."""
    camera_weight = _nan_inf(pos_pdf_a * vcm + (pos_pdf_a * dir_pdf_w) * vc)
    return 1.0 / (1.0 + camera_weight)


def weight_s1(light_rev_pdf_w, connect_pdf_w, eye_cur_rev_pdf_a,
              eye_prev_rev_pdf_w, vc, vcm):
    """s=1: next-event estimation (reference: bdpt.h:374-430)."""
    light_weight = _nan_inf(light_rev_pdf_w / connect_pdf_w)
    eye_weight = _nan_inf(eye_cur_rev_pdf_a * (vcm + eye_prev_rev_pdf_w * vc))
    return 1.0 / (light_weight + 1.0 + eye_weight)


def weight_connect(light_rev_a, light_prev_rev_pdf_w, lv_vc, lv_vcm,
                   eye_rev_a, eye_prev_rev_pdf_w, vc, vcm):
    """s>=2, t>=2 deterministic connection (reference: bdpt.h:434-483)."""
    light_weight = _nan_inf(
        light_rev_a * (lv_vcm + light_prev_rev_pdf_w * lv_vc))
    eye_weight = _nan_inf(eye_rev_a * (vcm + eye_prev_rev_pdf_w * vc))
    return 1.0 / (light_weight + 1.0 + eye_weight)


def weight_t1(reverse_pdf_a, n_light, prev_rev_pdf_w, vc, vcm):
    """t=1: light vertex splatted onto the image plane
    (reference: bdpt.h:335-353)."""
    light_weight = _nan_inf(
        (reverse_pdf_a / n_light) * (vcm + prev_rev_pdf_w * vc))
    return 1.0 / (light_weight + 1.0)
