"""Core vector math (port of bpt_tpu/core/math.py).

Vectors are tensors of shape (..., 3) and every helper broadcasts over
leading batch dimensions.  Small reductions over the last axis are
written out component by component, in the order XLA reduces them, so
the port rounds like the reference and like itself on every device.
"""
from __future__ import annotations

import torch

# Constants (reference: src/core/platform.h:51-57).
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_TWOPI = 1.0 / (2.0 * PI)
INV_FOURPI = 1.0 / (4.0 * PI)
DEG2RAD = PI / 180.0
# Ray min-t / Moeller-Trumbore determinant cutoff (reference: platform.h:57).
EPSILON = 1e-8
# Self-intersection cutoff: hits with t <= 1e-3 are rejected
# (reference: src/core/accel.h:43).
T_MIN_HIT = 1e-3
# Visibility rays stop just short of the target point
# (reference: src/integrators/bdpt.h:504).
VIS_SHORTEN = 1e-5

# Rec.709 luminance weights (reference: src/core/math.h:56-58), applied as
# f32 constants like the reference's f32 array.
_LUMA = (0.212671, 0.715160, 0.072169)


def dot(a, b):
    """Batched 3-vector dot product -> (...,)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length2(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length2(v))


def normalize(v):
    return v / torch.clamp_min(length(v), 1e-20)[..., None]


def luminance(rgb):
    """Rec.709 luminance (reference: src/core/math.h:56-58)."""
    return (rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1]
            + rgb[..., 2] * _LUMA[2])


def safe_sqrt(v):
    """sqrt(max(v, 0)) (reference: src/core/math.h:12-14)."""
    return torch.sqrt(torch.clamp_min(v, 0.0))


def barycentric(a, b, c, u, v):
    """a*(1-u-v) + b*u + c*v (reference: src/core/math.h:19-22)."""
    u = u[..., None]
    v = v[..., None]
    return a * (1.0 - u - v) + b * u + c * v


def coordinate_system(n):
    """Tangent/bitangent for a normal, the reference's branchy
    construction (reference: src/core/math.h:42-51); see
    bpt_tpu/core/math.py for the (s, t) naming."""
    ax, ay, az = n[..., 0], n[..., 1], n[..., 2]
    use_x = torch.abs(ax) > torch.abs(ay)
    inv_len_x = 1.0 / torch.sqrt(torch.clamp_min(ax * ax + az * az, 1e-30))
    inv_len_y = 1.0 / torch.sqrt(torch.clamp_min(ay * ay + az * az, 1e-30))
    zero = torch.zeros_like(ax)
    cx = torch.where(use_x, az * inv_len_x, zero)
    cy = torch.where(use_x, zero, az * inv_len_y)
    cz = torch.where(use_x, -ax * inv_len_x, -ay * inv_len_y)
    c = torch.stack([cx, cy, cz], dim=-1)
    b = cross(c, n)
    return b, c


def make_frame(n):
    """Shading frame rows (s, t, n) as (..., 3, 3)
    (reference: src/core/core.h:152-167)."""
    s, t = coordinate_system(n)
    return torch.stack([s, t, n], dim=-2)


def frame_to_local(frame, v):
    """World -> local: (dot(v,s), dot(v,t), dot(v,n))
    (reference: core.h:158-160)."""
    return torch.stack([dot(frame[..., 0, :], v), dot(frame[..., 1, :], v),
                        dot(frame[..., 2, :], v)], dim=-1)


def frame_to_world(frame, v):
    """Local -> world: s*x + t*y + n*z (reference: core.h:161-163)."""
    return (v[..., 0:1] * frame[..., 0, :] + v[..., 1:2] * frame[..., 1, :]
            + v[..., 2:3] * frame[..., 2, :])


def frame_n(frame):
    """The normal row of a frame."""
    return frame[..., 2, :]


def reflect_local(d):
    """Mirror reflection about +z in the local frame
    (reference: src/bsdfs/perfectmirror.h:29-31)."""
    return torch.stack([-d[..., 0], -d[..., 1], d[..., 2]], dim=-1)


def is_zero_rgb(v):
    """Exact all-channels-zero test (reference: bdpt.h:254, path.h:107)."""
    return torch.all(v == 0.0, dim=-1)


def fresnel_dielectric(eta_i, eta_t, cos_i, cos_t):
    """Exact dielectric Fresnel with TIR (reference: src/bsdfs/glass.h:40-53).

    cos_i, cos_t are non-negative magnitudes; TIR returns 1.  The
    grazing + TIR corner (both denominators zero) is guarded so no NaN
    appears on lanes the final select discards."""
    eta = eta_i / eta_t
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    d_par = (eta_t * cos_i) + (eta_i * cos_t)
    d_perp = (eta_i * cos_i) + (eta_t * cos_t)
    one = torch.ones_like(d_par)
    d_par = torch.where(torch.abs(d_par) < 1e-12, one, d_par)
    d_perp = torch.where(torch.abs(d_perp) < 1e-12, one, d_perp)
    r_par = ((eta_t * cos_i) - (eta_i * cos_t)) / d_par
    r_perp = ((eta_i * cos_i) - (eta_t * cos_t)) / d_perp
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(sin2_t >= 1.0, one, fr)
