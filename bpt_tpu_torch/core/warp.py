"""Square -> distribution warps and their pdfs used by BSDF and emitter
sampling (port of bpt_tpu/core/warp.py), including the reference's
quirks: uniform-hemisphere emission with cosTheta = u.y and the "minus"
concentric-disk variant (reference: src/core/math.h:118-268).  Samplers
take u of shape (..., 2) and return local-frame (+z up) directions
(..., 3), or (..., 2) for the 2D warps."""
from __future__ import annotations

import torch

from .math import INV_FOURPI, INV_PI, INV_TWOPI, PI


def _sphere_dir(phi, cos_theta):
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)


def square_to_uniform_sphere(u):
    """(reference: math.h:119-127)"""
    return _sphere_dir(u[..., 0] * (2.0 * PI), 1.0 - 2.0 * u[..., 1])


def square_to_uniform_sphere_pdf():
    return INV_FOURPI


def square_to_uniform_hemisphere(u):
    """cosTheta = u.y directly (reference: math.h:136-144)."""
    return _sphere_dir(u[..., 0] * (2.0 * PI), u[..., 1])


def square_to_uniform_hemisphere_pdf(_v=None):
    """Constant 1/(2 pi); the reference ignores its argument
    (math.h:146-151)."""
    return INV_TWOPI


def square_to_uniform_disk_concentric(u):
    """Concentric disk mapping, reference variant (math.h:153-180)."""
    rx = 2.0 * u[..., 0] - 1.0
    ry = 2.0 * u[..., 1] - 1.0
    use_x = (rx * rx) > (ry * ry)
    one = torch.ones_like(rx)
    zero = torch.zeros_like(rx)
    safe_rx = torch.where(rx == 0.0, one, rx)
    safe_ry = torch.where(ry == 0.0, one, ry)
    radius = torch.where(use_x, rx, ry)
    phi = torch.where(
        use_x,
        (PI * 0.25) * (ry / safe_rx),
        (PI * 0.5) - (PI * 0.25) * (rx / safe_ry),
    )
    both_zero = (rx == 0.0) & (ry == 0.0)
    radius = torch.where(both_zero, zero, radius)
    phi = torch.where(both_zero, zero, phi)
    return torch.stack([radius * torch.cos(phi), radius * torch.sin(phi)],
                       dim=-1)


def square_to_cosine_hemisphere(u):
    """Disk lift (reference: math.h:182-192)."""
    d = square_to_uniform_disk_concentric(u)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    z = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(v):
    """cos(theta)/pi for z >= 0 else 0 (reference: math.h:194-208)."""
    z = v[..., 2]
    return torch.where(z >= 0.0, z * INV_PI, torch.zeros_like(z))


def square_to_phong_lobe(u, exponent):
    """Modified-Phong lobe sample, cosTheta = u.x^(1/(n+2))
    (reference: math.h:210-219)."""
    cos_theta = torch.pow(u[..., 0], 1.0 / (exponent + 2.0))
    return _sphere_dir(u[..., 1] * (2.0 * PI), cos_theta)


def square_to_phong_lobe_pdf(v, exponent):
    """(n+2)/(2 pi) cos^n(theta) for z >= 0 else 0 (reference:
    math.h:221-227; not the true density of square_to_phong_lobe, a
    reference quirk kept for parity, see bpt_tpu/core/warp.py)."""
    z = v[..., 2]
    val = (exponent + 2.0) * INV_TWOPI * torch.pow(torch.clamp_min(z, 0.0),
                                                   exponent)
    return torch.where(z >= 0.0, val, torch.zeros_like(val))


def square_to_uniform_triangle(u):
    """Uniform barycentric (u, v) on a triangle (reference: math.h:229-234)."""
    a = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    return torch.stack([1.0 - a, a * u[..., 1]], dim=-1)


def square_to_uniform_cone(u, cos_theta_max):
    """(reference: math.h:236-245)"""
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    return _sphere_dir(u[..., 1] * (2.0 * PI), cos_theta)


def square_to_uniform_cone_pdf(cos_theta_max):
    """(reference: math.h:247-254)"""
    return INV_TWOPI / (1.0 - cos_theta_max)
