"""Bitmap textures: loading, the padded atlas, and the UV lookup (port
of bpt_tpu/scene/textures.py).

Loading, packing and the Texture<T> classes (`ConstantTexture3f/1f`,
`BitmapTexture3f/1f`) stay numpy on the host; `albedo_at` runs on the
device.  Semantics are the reference renderer's (src/core/core.h:405-640):
`map_Kd` retargeted to a sibling .ppm, PPM gamma-expanded with 2.2, both
formats v-flipped at load, nearest-texel lookup of the +1-wrapped
barycentric UV.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np
import torch

from ..ops.gather import gather_rows


def load_ppm(path: str) -> np.ndarray:
    """Binary P6 PPM -> (H, W, 3) float32, gamma-expanded + v-flipped."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    pos = 0
    while len(tokens) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[pos:])
        if m is None:
            raise ValueError(f"{path}: bad PPM header")
        tok = m.group(1)
        pos += m.end()
        if not tok.startswith(b"#"):
            tokens.append(tok)
    magic, w, h, maxval = (tokens[0], int(tokens[1]), int(tokens[2]),
                           int(tokens[3]))
    if magic != b"P6":
        raise ValueError(f"{path}: only binary P6 PPM supported")
    raw = np.frombuffer(data, np.uint8, count=w * h * 3,
                        offset=len(data) - w * h * 3)
    img = raw.reshape(h, w, 3).astype(np.float32)
    img = np.power(img / float(maxval), 2.2)
    return img[::-1].copy()


def load_pfm(path: str) -> np.ndarray:
    """PFM -> (H, W, 3) float32, v-flipped."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        count = w * h * (3 if magic == b"PF" else 1)
        data = np.fromfile(f, "<f4" if scale < 0 else ">f4", count)
    img = data.reshape(h, w, -1)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img[::-1].astype(np.float32).copy()


def load_texture(path: str) -> Optional[np.ndarray]:
    """Any map name is retargeted to a sibling .ppm (core.h:493-500);
    .pfm loads as float.  None when nothing loadable exists."""
    base, ext = os.path.splitext(path)
    candidates = [base + ".ppm", path] if ext.lower() != ".pfm" else [path]
    for c in candidates:
        if os.path.exists(c):
            try:
                if c.lower().endswith(".pfm"):
                    return load_pfm(c)
                return load_ppm(c)
            except (OSError, ValueError):
                continue
    return None


def build_atlas(images: List[np.ndarray]):
    """Pack images into (N, Hmax, Wmax, 3) + (N, 2) sizes."""
    if not images:
        return (np.zeros((0, 1, 1, 3), np.float32),
                np.zeros((0, 2), np.int32))
    hm = max(i.shape[0] for i in images)
    wm = max(i.shape[1] for i in images)
    atlas = np.zeros((len(images), hm, wm, 3), np.float32)
    sizes = np.zeros((len(images), 2), np.int32)
    for n, img in enumerate(images):
        h, w = img.shape[:2]
        atlas[n, :h, :w] = img
        sizes[n] = (h, w)
    return atlas, sizes


# ---------------------------------------------------------------------------
# Texture<T> interface parity (reference: core.h:405-640)
# ---------------------------------------------------------------------------
#
# The reference exposes eval/getAverage/getMin/getMax on Constant and
# Bitmap textures in both 3f and 1f flavors.  Only BitmapTexture3f's
# eval is on the BDPT hot path (map_Kd, handled by albedo_at below);
# the rest are host-side scene-description utilities, so they live here
# as plain numpy classes (copies of bpt_tpu/scene/textures.py's).


class ConstantTexture3f:
    """(reference: core.h:503-513)"""

    def __init__(self, value):
        self.value = np.asarray(value, np.float32)

    def eval(self, st=None):
        return self.value

    def average(self):
        return self.value

    def min(self):
        return self.value

    def max(self):
        return self.value


class ConstantTexture1f:
    """(reference: core.h:515-525)"""

    def __init__(self, value):
        self.value = float(value)

    def eval(self, st=None):
        return self.value

    def average(self):
        return self.value

    def min(self):
        return self.value

    def max(self):
        return self.value


class BitmapTexture3f:
    """(reference: core.h:527-587).  img: (H, W, 3) float32 as produced
    by load_texture (already gamma-expanded + v-flipped)."""

    def __init__(self, img):
        self.img = np.asarray(img, np.float32)

    def eval(self, st):
        """Nearest texel of the +1-wrapped UV (core.h:569-587)."""
        st = np.asarray(st, np.float64) + 1.0
        st = st - np.floor(st)
        h, w = self.img.shape[:2]
        x = int(np.clip(int(st[0] * w), 0, w - 1))
        y = int(np.clip(int(st[1] * h), 0, h - 1))
        return self.img[y, x]

    def average(self):
        return self.img.reshape(-1, 3).mean(0)

    def min(self):
        return self.img.reshape(-1, 3).min(0)

    def max(self):
        return self.img.reshape(-1, 3).max(0)


class BitmapTexture1f:
    """(reference: core.h:589-640).

    Reference quirks replicated for parity: the stored texel array is
    RGB-interleaved but eval indexes it FLAT at (w*y + x) — i.e. it
    reads a red/green/blue component depending on position rather than
    a proper single channel (core.h:631-637) — and getMin/getMax loop
    over only the first size/3 entries (core.h:609-620); getAverage
    averages ALL interleaved components (core.h:601-607).

    Deliberately NOT replicated: the reference's accumulator-init quirk
    (getMax starts at +FLT_MIN and getMin at FLT_MAX, core.h:610,616; the
    3f getMax starts at -FLT_MIN), which only shows through for all-zero
    or all-negative textures — min()/max() here return the true extrema
    of the scanned range instead."""

    def __init__(self, img):
        self.img = np.asarray(img, np.float32)
        self._flat = self.img.reshape(-1)

    def eval(self, st):
        st = np.asarray(st, np.float64) + 1.0
        st = st - np.floor(st)
        h, w = self.img.shape[:2]
        x = int(np.clip(int(st[0] * w), 0, w - 1))
        y = int(np.clip(int(st[1] * h), 0, h - 1))
        return float(self._flat[w * y + x])

    def average(self):
        return float(self._flat.mean())

    def min(self):
        return float(self._flat[: self._flat.size // 3].min())

    def max(self):
        return float(self._flat[: self._flat.size // 3].max())


def albedo_at(scene, tri, u, v):
    """Textured Kd at a hit, or None when the scene has no textures
    (BitmapTexture3f::eval, core.h:569-587).  Lanes whose material has no
    texture get the constant Kd."""
    if scene.tex_atlas.shape[0] == 0:
        return None
    tri = tri.long()
    uv = (scene.uv0[tri] * (1.0 - u - v)[:, None]
          + scene.uv1[tri] * u[:, None]
          + scene.uv2[tri] * v[:, None])
    st = uv + 1.0
    st = st - torch.floor(st)
    mid = scene.mat_id[tri].long()
    tex = scene.mat_tex[mid]
    has = tex >= 0
    tex_c = torch.clamp_min(tex, 0).long()
    hwx = scene.tex_size[tex_c]
    h = hwx[:, 0]
    w = hwx[:, 1]
    x = torch.minimum(torch.clamp_min((st[:, 0] * w).to(torch.int32), 0),
                      w - 1)
    y = torch.minimum(torch.clamp_min((st[:, 1] * h).to(torch.int32), 0),
                      h - 1)
    texel = scene.tex_atlas[tex_c, y.long(), x.long()]
    kd = gather_rows((scene.mat.diffuse,), mid)[0]
    return torch.where(has[:, None], texel, kd)
