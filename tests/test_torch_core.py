"""Warps, frames and camera of the port against the reference package
(rtol 1e-6, atol 1e-7: both are f32 in the same operation order).

XLA's and PyTorch's f32 cos/sin round differently in the last ulp; the
warps that lift a disk point with sqrt(1 - r^2) amplify that one ulp
near the rim (measured 5.8e-7 absolute on unit vectors), so those
compare with atol 1e-6 (LIFT_ATOL)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import camera as jcam
from bpt_tpu.core import math as jm
from bpt_tpu.core import warp as jw
from bpt_tpu_torch.core import camera as tcam
from bpt_tpu_torch.core import math as tm
from bpt_tpu_torch.core import warp as tw

N = 4096
RTOL, ATOL = 1e-6, 1e-7
LIFT_ATOL = 1e-6


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def _u2(seed=0, n=N):
    u = np.random.RandomState(seed).rand(n, 2).astype(np.float32)
    u[:8] = [[0, 0], [0.5, 0.5], [0, 1], [1, 0], [0.5, 0], [0, 0.5],
             [0.25, 0.75], [0.999, 0.001]]
    return u


def _dirs(seed=1, n=N):
    d = np.random.RandomState(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


WARPS_U = [
    ("square_to_uniform_hemisphere", LIFT_ATOL),
    ("square_to_uniform_disk_concentric", ATOL),
    ("square_to_cosine_hemisphere", LIFT_ATOL),
    ("square_to_uniform_triangle", ATOL),
]


@pytest.mark.parametrize("name,atol", WARPS_U)
def test_warp(name, atol):
    u = _u2()
    _close(getattr(jw, name)(jnp.asarray(u)),
           getattr(tw, name)(torch.from_numpy(u)), atol=atol)


def test_phong_lobe_and_pdfs():
    u = _u2(2)
    n = np.random.RandomState(3).uniform(0, 60, N).astype(np.float32)
    jd = jw.square_to_phong_lobe(jnp.asarray(u), jnp.asarray(n))
    td = tw.square_to_phong_lobe(torch.from_numpy(u), torch.from_numpy(n))
    _close(jd, td, rtol=1e-5, atol=1e-6)
    v = _dirs(4)
    _close(jw.square_to_phong_lobe_pdf(jnp.asarray(v), jnp.asarray(n)),
           tw.square_to_phong_lobe_pdf(torch.from_numpy(v),
                                       torch.from_numpy(n)),
           rtol=1e-5, atol=1e-6)
    _close(jw.square_to_cosine_hemisphere_pdf(jnp.asarray(v)),
           tw.square_to_cosine_hemisphere_pdf(torch.from_numpy(v)))


@pytest.mark.parametrize("fn", ["normalize", "luminance", "make_frame",
                                "length", "reflect_local", "is_zero_rgb"])
def test_unary_math(fn):
    v = _dirs(6) * np.float32(2.5)
    v[:4] = [[0, 0, 1], [0, 1, 0], [1, 0, 0], [0, 0, 0]]
    j = getattr(jm, fn)(jnp.asarray(v))
    t = getattr(tm, fn)(torch.from_numpy(v))
    if t.dtype == torch.bool:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    else:
        _close(j, t)


def test_frame_round_trip():
    n, v = _dirs(7), _dirs(8)
    jf = jm.make_frame(jnp.asarray(n))
    tf = tm.make_frame(torch.from_numpy(n))
    _close(jm.frame_to_local(jf, jnp.asarray(v)),
           tm.frame_to_local(tf, torch.from_numpy(v)))
    _close(jm.frame_to_world(jf, jnp.asarray(v)),
           tm.frame_to_world(tf, torch.from_numpy(v)))
    back = tm.frame_to_world(tf, tm.frame_to_local(tf, torch.from_numpy(v)))
    np.testing.assert_allclose(back.numpy(), v, atol=1e-5)


def test_fresnel_dielectric_including_tir():
    rs = np.random.RandomState(9)
    eta_i = rs.choice([1.0, 1.5], N).astype(np.float32)
    eta_t = np.where(eta_i == 1.0, 1.5, 1.0).astype(np.float32)
    cos_i = rs.rand(N).astype(np.float32)
    cos_t = rs.rand(N).astype(np.float32)
    cos_i[:2] = 0.0
    cos_t[:2] = 0.0
    args = (eta_i, eta_t, cos_i, cos_t)
    j = jm.fresnel_dielectric(*map(jnp.asarray, args))
    t = tm.fresnel_dielectric(*map(torch.from_numpy, args))
    _close(j, t)
    assert float(t.max()) == 1.0  # TIR lanes


def _cams(w=48, h=32):
    kw = dict(o=[0.0, 1.0, 3.8], at=[0.0, 1.0, 0.0], up=[0.0, 1.0, 0.0],
              fov=39.0, width=w, height=h)
    return jcam.Camera.make(**kw), tcam.Camera.make(**kw)


def test_device_constants_equal():
    jc, tc = _cams()
    jd = jc.device_constants()
    td = tc.device_constants("cpu")
    for k in tcam.CAM_CONST_KEYS:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    fa = tcam.cam_consts_from_arrays({k: np.asarray(v) for k, v in
                                      jd.items()}, "cpu")
    for k in tcam.CAM_CONST_KEYS:
        assert torch.equal(fa[k], td[k])


@pytest.mark.parametrize("jitter", [False, True])
def test_generate_rays(jitter):
    jc, tc = _cams()
    w, h = jc.width, jc.height
    pix = np.arange(w * h, dtype=np.int32)
    jit = np.random.RandomState(10).rand(w * h, 2).astype(np.float32)
    jo, jd = jcam.generate_rays(jc.device_constants(), w, h, jnp.asarray(pix),
                                jnp.asarray(jit) if jitter else None)
    to, td = tcam.generate_rays(tc.device_constants("cpu"), w, h,
                                torch.from_numpy(pix),
                                torch.from_numpy(jit) if jitter else None)
    _close(jo, to)
    _close(jd, td)


def test_splat_to_image_plane():
    jc, tc = _cams()
    w, h = jc.width, jc.height
    rs = np.random.RandomState(11)
    p = rs.uniform([-1, 0, -1], [1, 2, 1], (N, 3)).astype(np.float32)
    p[:3] = [[0.0, 1.0, 3.8], [5.0, 1.0, 3.8], [0.0, 1.0, 10.0]]
    jx, jy, jin = jcam.splat_to_image_plane(jc.device_constants(), w, h,
                                            jnp.asarray(p))
    tx, ty, tin = tcam.splat_to_image_plane(tc.device_constants("cpu"), w, h,
                                            torch.from_numpy(p))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(tx.numpy()[tin.numpy()],
                                  np.asarray(jx)[np.asarray(jin)])
    np.testing.assert_array_equal(ty.numpy()[tin.numpy()],
                                  np.asarray(jy)[np.asarray(jin)])
