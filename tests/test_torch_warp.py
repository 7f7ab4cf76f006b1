"""The port's warps and math helpers: the ones the other integrators need
(uniform sphere, uniform-hemisphere pdf, uniform cone, safe_sqrt,
frame_n) against the reference package on the same inputs within a few
ulp, and the Monte Carlo and chi-square tests of tests/test_warp.py and
tests/test_chisquare.py run on the port's warps, with the same sample
counts, bins and gates (the 0.999 chi-square quantile)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import math as jmath
from bpt_tpu.core import warp as jwarp
from bpt_tpu_torch.core import math as tmath
from bpt_tpu_torch.core import warp as twarp
from bpt_tpu_torch.core.math import PI
from test_torch_bdpt import _one_thread  # noqa: F401  (a fixture)

N_MC = 200_000
N_CHI = 400_000
NZ, NPHI = 16, 16
# sin/cos/sqrt of XLA and PyTorch differ by an ulp or two; the lifted
# z = sqrt(1 - c^2) turns that into ~1e-6 near the poles.
RTOL, ATOL = 4e-7, 2e-6


def _u2(seed, n):
    """U[0, 1)^2 in f32: multiples of 2^-24, so none rounds up to 1."""
    k = np.random.RandomState(seed).randint(0, 1 << 24, (n, 2))
    return (k / float(1 << 24)).astype(np.float32)


def _t(seed, n=N_MC):
    return torch.from_numpy(_u2(seed, n))


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def test_new_warps_match_the_reference():
    u = _u2(1, 4096)
    u[:4] = [[0.0, 0.0], [0.999999, 0.999999], [0.5, 0.5], [0.25, 1.0]]
    cos_max = np.random.RandomState(2).rand(4096).astype(np.float32)
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    _close(twarp.square_to_uniform_sphere(tu),
           jwarp.square_to_uniform_sphere(ju))
    _close(twarp.square_to_uniform_cone(tu, torch.from_numpy(cos_max)),
           jwarp.square_to_uniform_cone(ju, jnp.asarray(cos_max)))
    _close(twarp.square_to_uniform_cone(tu, 0.8),
           jwarp.square_to_uniform_cone(ju, 0.8))
    _close(twarp.square_to_uniform_cone_pdf(torch.from_numpy(cos_max)),
           jwarp.square_to_uniform_cone_pdf(jnp.asarray(cos_max)))
    assert twarp.square_to_uniform_sphere_pdf() == \
        jwarp.square_to_uniform_sphere_pdf()
    assert twarp.square_to_uniform_hemisphere_pdf() == \
        jwarp.square_to_uniform_hemisphere_pdf() == \
        twarp.square_to_uniform_hemisphere_pdf(tu)


def test_math_helpers_match_the_reference():
    x = np.random.RandomState(3).normal(size=(4096, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmath.frame_n(torch.from_numpy(x)),
                                  jmath.frame_n(jnp.asarray(x)))
    v = x[:, 0, 0]
    v[:3] = [0.0, -0.0, -1e-30]
    # XLA:CPU's f32 sqrt is not correctly rounded: 1 ulp off at ~0.3%.
    np.testing.assert_allclose(tmath.safe_sqrt(torch.from_numpy(v)),
                               jmath.safe_sqrt(jnp.asarray(v)), rtol=RTOL,
                               atol=0.0)
    assert tmath.INV_FOURPI == jmath.INV_FOURPI


# --- tests/test_warp.py on the port's warps ---------------------------------

def test_uniform_hemisphere_consistency():
    d = twarp.square_to_uniform_hemisphere(_t(7))
    est = torch.mean(d[:, 2] / twarp.square_to_uniform_hemisphere_pdf())
    assert np.isclose(float(est), PI, rtol=1e-2)
    assert float(d[:, 2].min()) >= 0.0
    assert np.allclose(np.linalg.norm(d.numpy(), axis=1), 1.0, atol=1e-5)


def test_cosine_hemisphere_consistency():
    d = twarp.square_to_cosine_hemisphere(_t(7))
    pdf = twarp.square_to_cosine_hemisphere_pdf(d)
    assert np.isclose(float(torch.mean(d[:, 2] / pdf)), PI, rtol=1e-2)
    assert np.allclose(np.linalg.norm(d.numpy(), axis=1), 1.0, atol=1e-4)


def test_cosine_hemisphere_pdf_integrates_to_one():
    d = twarp.square_to_uniform_sphere(_t(7))
    pdf = twarp.square_to_cosine_hemisphere_pdf(d)
    est = torch.mean(pdf / twarp.square_to_uniform_sphere_pdf())
    assert np.isclose(float(est), 1.0, rtol=2e-2)


@pytest.mark.parametrize("exponent", [1.0, 10.0, 100.0])
def test_phong_lobe_pdf_integral_matches_reference_quirk(exponent):
    """The reference's phong-lobe pdf integrates to (n+2)/(n+1), not 1
    (math.h:210-227); kept for estimator parity."""
    d = twarp.square_to_uniform_sphere(_t(7))
    pdf = twarp.square_to_phong_lobe_pdf(d, exponent)
    est = torch.mean(pdf / twarp.square_to_uniform_sphere_pdf())
    assert np.isclose(float(est), (exponent + 2.0) / (exponent + 1.0),
                      rtol=5e-2)


@pytest.mark.parametrize("exponent", [2.0, 30.0])
def test_phong_lobe_sample_matches_pdf(exponent):
    """Mean cos(theta) of the samples: (n+2)/(n+3)."""
    d = twarp.square_to_phong_lobe(_t(7), exponent)
    assert np.isclose(float(torch.mean(d[:, 2])),
                      (exponent + 2.0) / (exponent + 3.0), rtol=1e-2)


def test_uniform_triangle_mean_is_centroid():
    uv = twarp.square_to_uniform_triangle(_t(7)).numpy()
    assert np.allclose(uv.mean(0), [1.0 / 3.0, 1.0 / 3.0], atol=5e-3)
    assert (uv >= 0).all() and (uv.sum(1) <= 1.0 + 1e-6).all()


def test_uniform_sphere_mean_zero():
    d = twarp.square_to_uniform_sphere(_t(7)).numpy()
    assert np.allclose(d.mean(0), 0.0, atol=5e-3)


def test_uniform_cone_solid_angle():
    """E[1 / pdf] over cone samples is the cone's solid angle,
    2 pi (1 - cos_max), and every sample lies inside the cone."""
    c = 0.6
    d = twarp.square_to_uniform_cone(_t(7), c)
    assert float(d[:, 2].min()) >= c - 1e-6
    est = float(torch.mean(1.0 / twarp.square_to_uniform_cone_pdf(
        torch.full((N_MC,), c))))
    assert np.isclose(est, 2.0 * PI * (1.0 - c), rtol=1e-5)


# --- tests/test_chisquare.py on the port's warps ----------------------------

def _chi2_crit(dof, z=3.09):
    """0.999 chi-square quantile via Wilson-Hilferty."""
    return dof * (1.0 - 2.0 / (9.0 * dof)
                  + z * np.sqrt(2.0 / (9.0 * dof))) ** 3


def _chi2_grid(d, z_edges, z_cdf):
    """Pearson chi-square of unit vectors on the z-bins x phi-bins grid;
    phi is uniform for every tested warp."""
    d = d.numpy()
    z = np.clip(d[:, 2], z_edges[0], z_edges[-1])
    phi = np.arctan2(d[:, 1], d[:, 0])
    zi = np.clip(np.searchsorted(z_edges, z, side="right") - 1, 0, NZ - 1)
    pi = np.clip(((phi + np.pi) / (2 * np.pi) * NPHI).astype(int), 0,
                 NPHI - 1)
    obs = np.zeros((NZ, NPHI))
    np.add.at(obs, (zi, pi), 1.0)
    pz = np.diff(z_cdf(np.asarray(z_edges, np.float64)))
    exp = np.outer(pz, np.full(NPHI, 1.0 / NPHI)) * len(d)
    assert exp.min() > 8, "rebin: expected counts too small"
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    return chi2, _chi2_crit(NZ * NPHI - 1)


def _chi_u2():
    return _t(11, N_CHI)


@pytest.mark.parametrize("warp,lo,cdf", [
    ("uniform_sphere", -1.0, lambda e: (e + 1.0) / 2.0),
    ("uniform_hemisphere", 0.0, lambda e: e),
    ("cosine_hemisphere", 0.0, lambda e: e ** 2),
])
def test_sphere_warp_chi_square(warp, lo, cdf):
    d = getattr(twarp, "square_to_" + warp)(_chi_u2())
    chi2, crit = _chi2_grid(d, np.linspace(lo, 1.0, NZ + 1), cdf)
    assert chi2 < crit, (chi2, crit)


@pytest.mark.parametrize("n", [1.0, 30.0])
def test_phong_lobe_chi_square(n):
    """The sampler's true density is (n+2)/(2 pi) cos^(n+1), so
    P(z <= e) = e^(n+2); equal-probability edges."""
    d = twarp.square_to_phong_lobe(_chi_u2(), n)
    edges = np.linspace(0.0, 1.0, NZ + 1) ** (1.0 / (n + 2.0))
    chi2, crit = _chi2_grid(d, edges, lambda e: e ** (n + 2.0))
    assert chi2 < crit, (chi2, crit)


def test_uniform_cone_chi_square():
    c = 0.8
    d = twarp.square_to_uniform_cone(_chi_u2(), c)
    chi2, crit = _chi2_grid(d, np.linspace(c, 1.0, NZ + 1),
                            lambda e: (e - c) / (1.0 - c))
    assert chi2 < crit, (chi2, crit)


def test_concentric_disk_chi_square():
    p = twarp.square_to_uniform_disk_concentric(_chi_u2()).numpy()
    r = np.sqrt((p ** 2).sum(1))
    phi = np.arctan2(p[:, 1], p[:, 0])
    ri = np.clip((r ** 2 * NZ).astype(int), 0, NZ - 1)  # r^2 uniform
    pi = np.clip(((phi + np.pi) / (2 * np.pi) * NPHI).astype(int), 0,
                 NPHI - 1)
    obs = np.zeros((NZ, NPHI))
    np.add.at(obs, (ri, pi), 1.0)
    exp = np.full((NZ, NPHI), len(p) / (NZ * NPHI))
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert chi2 < _chi2_crit(NZ * NPHI - 1), chi2


def test_uniform_triangle_chi_square():
    """u and v each have density 2(1 - x) on [0, 1]."""
    uv = twarp.square_to_uniform_triangle(_chi_u2()).numpy()
    k = 32
    edges = np.linspace(0.0, 1.0, k + 1)
    pz = np.diff(1.0 - (1.0 - edges) ** 2)
    for x in (uv[:, 0], uv[:, 1]):
        xi = np.clip(np.searchsorted(edges, x, side="right") - 1, 0, k - 1)
        obs = np.bincount(xi, minlength=k).astype(np.float64)
        exp = pz * len(x)
        assert float(((obs - exp) ** 2 / exp).sum()) < _chi2_crit(k - 1)
    assert (uv.sum(1) <= 1.0 + 1e-6).all() and (uv >= -1e-6).all()


def test_chi_square_catches_shape_error():
    """A wrong distribution (uniform z claimed cosine-weighted) fails the
    same gate."""
    d = twarp.square_to_uniform_hemisphere(_chi_u2())
    chi2, crit = _chi2_grid(d, np.linspace(0.0, 1.0, NZ + 1),
                            lambda e: e ** 2)
    assert chi2 > crit
