"""Pinhole camera: ray generation and image-plane splatting (port of
bpt_tpu/core/camera.py).

The matrices are computed once on the host in numpy, exactly as the
reference package does, and handed to the device as a dict of tensors
(`Camera.device_constants`).  See bpt_tpu/core/camera.py for the
reference renderer's conventions this replicates (vertical fov, the
half-pixel spp>1 jitter, trunc-toward-zero splat snapping).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .math import DEG2RAD

CAM_CONST_KEYS = ("o", "forward", "rot_t", "view_proj", "angle", "aspect",
                  "vnpd")


def look_at(eye, center, up):
    """glm::lookAt (right-handed): world->camera 4x4."""
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_rad, aspect, near, far):
    """glm::perspective (right-handed, NDC z in [-1,1])."""
    t = np.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera description + host-side matrices."""

    o: np.ndarray
    at: np.ndarray
    up: np.ndarray
    fov: float             # vertical, degrees
    width: int
    height: int
    near: float = 1.0
    far: float = 1000.0

    @staticmethod
    def make(o, at, up, fov, width, height):
        return Camera(
            o=np.asarray(o, np.float32),
            at=np.asarray(at, np.float32),
            up=np.asarray(up, np.float32),
            fov=float(fov),
            width=int(width),
            height=int(height),
        )

    @property
    def aspect(self):
        return float(self.width) / float(self.height)

    @property
    def angle(self):
        """tan(fov/2) image-plane half-height (renderer.cpp:149)."""
        return float(np.tan(DEG2RAD * self.fov * 0.5))

    @property
    def forward(self):
        f = self.at.astype(np.float64) - self.o.astype(np.float64)
        return (f / np.linalg.norm(f)).astype(np.float32)

    @property
    def world_to_camera(self):
        return look_at(self.o, self.at, self.up)

    @property
    def cam_rotation_t(self):
        """Columns (s, u, -f): camera->world rotation."""
        return self.world_to_camera[:3, :3].T

    @property
    def view_proj(self):
        """perspective @ lookAt, used by splatting (bdpt.h:487-492)."""
        p = perspective(DEG2RAD * self.fov, self.aspect, self.near, self.far)
        return (p @ self.world_to_camera).astype(np.float32)

    @property
    def virtual_near_plane_distance(self):
        """Distance at which one pixel has unit area (bdpt.h:52)."""
        return (1.0 / self.angle) * self.height * 0.5

    def host_constants(self):
        """The constants as f32 numpy arrays (what the reference package
        holds as jnp arrays)."""
        return {
            "o": np.asarray(self.o, np.float32),
            "forward": np.asarray(self.forward, np.float32),
            "rot_t": self.cam_rotation_t.astype(np.float32),
            "view_proj": np.asarray(self.view_proj, np.float32),
            "angle": np.float32(self.angle),
            "aspect": np.float32(self.aspect),
            "vnpd": np.float32(self.virtual_near_plane_distance),
        }

    def device_constants(self, device):
        """Bundle of f32 tensors on `device`."""
        return cam_consts_from_arrays(self.host_constants(), device)


def cam_consts_from_arrays(arrays, device):
    """Camera constants from numpy arrays keyed like
    `Camera.device_constants` (e.g. `np.asarray` of the reference
    package's jnp constants), as f32 tensors on `device`."""
    return {k: torch.tensor(np.asarray(arrays[k], np.float32),
                            device=device) for k in CAM_CONST_KEYS}


def _matvec(m, v):
    """m (n, k) applied to rows of v (..., k), summed left to right."""
    cols = [m[:, j] * v[..., j:j + 1] for j in range(m.shape[1])]
    out = cols[0]
    for c in cols[1:]:
        out = out + c
    return out


def generate_rays(cam_consts, width, height, pixel_idx, jitter=None):
    """Primary ray origins/directions for flat pixel indices
    (row-major, y*W + x).  jitter: optional (B, 2) U[0,1)^2, the
    reference's spp>1 jitter (renderer.cpp:183-192); None shoots through
    pixel centers.  Returns (o (B,3), d (B,3))."""
    j = (pixel_idx % width).to(torch.float32)
    i = torch.div(pixel_idx, width, rounding_mode="floor").to(torch.float32)
    inv_w = 1.0 / width
    inv_h = 1.0 / height
    y = (1.0 - (i + 0.5) * inv_h) * 2.0 - 1.0
    x = ((j + 0.5) * inv_w) * 2.0 - 1.0
    if jitter is not None:
        x = x + (jitter[..., 0] - 0.5) * inv_w
        y = y + (jitter[..., 1] - 0.5) * inv_h
    angle = cam_consts["angle"]
    aspect = cam_consts["aspect"]
    local = torch.stack([x * angle * aspect, y * angle, -torch.ones_like(x)],
                        dim=-1)
    d = _matvec(cam_consts["rot_t"], local)
    d = d / torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                       + d[..., 2] * d[..., 2])[..., None]
    o = cam_consts["o"].expand(d.shape)
    return o, d


def _trunc_to_int32(x):
    """trunc toward zero, then XLA's saturating float->int32 conversion
    (NaN -> 0), so off-screen and degenerate projections map like the
    reference package's."""
    x = torch.nan_to_num(torch.trunc(x), nan=0.0, posinf=2.0**31,
                         neginf=-2.0**31)
    return x.to(torch.int64).clamp(-2**31, 2**31 - 1).to(torch.int32)


def splat_to_image_plane(cam_consts, width, height, p):
    """World point p (B,3) -> integer pixel coords (bdpt.h:485-496).
    Returns (x_pixel (B,) int32, y_pixel (B,) int32, in_bounds (B,))."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    clip = _matvec(cam_consts["view_proj"], ph)
    ndc = clip[..., :3] / clip[..., 3:4]
    fx = width * (ndc[..., 0] + 1.0) * 0.5
    fy = height * (1.0 - ndc[..., 1]) * 0.5
    x_pix = _trunc_to_int32(fx)
    y_pix = _trunc_to_int32(fy)
    in_bounds = (x_pix >= 0) & (y_pix >= 0) & (x_pix < width) & (
        y_pix < height)
    return x_pix, y_pix, in_bounds
