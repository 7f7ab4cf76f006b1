"""MIS sum-to-one invariant of the port's recursive weights
(bpt_tpu_torch/integrators/mis.py), as tests/test_mis.py holds the
reference package's: along hand-built analytic paths the recursive vc/vcm
weights of every (s,t) technique match a direct computation (products of
area-measure pdfs) and sum to one; an injected recursion error breaks the
invariant.  Float64 tensors, so the comparison tests the recursion and
not rounding."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bpt_tpu_torch.core.math import INV_TWOPI
from bpt_tpu_torch.integrators import mis as m

INV_PI = 1.0 / np.pi


def T(x):
    return torch.tensor(x, dtype=torch.float64)


FALSE, TRUE = torch.tensor(False), torch.tensor(True)


def _norm(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def _cos(n, v):
    return float(np.dot(_norm(n), _norm(v)))


def _cospdf(n, v):
    """Cosine-hemisphere pdf (diffuse BSDF sampling), solid angle."""
    return max(_cos(n, v), 0.0) * INV_PI


def _g(a, b, n_b):
    """Geometry term: solid angle at a -> area at b."""
    d2 = float(np.sum((np.asarray(b, np.float64) - a) ** 2))
    return abs(_cos(n_b, np.asarray(a, np.float64) - b)) / d2


class Cam:
    """Pinhole-camera constants as core/camera.py computes them."""

    def __init__(self, o, forward, vnpd, n_light):
        self.o = np.asarray(o, np.float64)
        self.f = _norm(forward)
        self.vnpd = float(vnpd)
        self.n_light = float(n_light)

    def t1_pdf(self, d):
        """Image-area -> solid-angle jacobian for direction d
        (bdpt.h:49-62)."""
        cos_a = _cos(self.f, d)
        ipd = self.vnpd / cos_a
        return ipd * ipd / cos_a

    def q_cam(self, x1, n1):
        """Camera-technique pdf of vertex x1, area measure, with the
        1/(W*H) light-path count folded in."""
        return self.t1_pdf(x1 - self.o) * _g(self.o, x1, n1) / self.n_light


def _bounce(vc, vcm, cos_out, pdf, rev, delta=FALSE):
    return m.bounce_update(vc, vcm, T(cos_out), T(pdf), T(rev), delta)


def _measure(vc, vcm, dist2, cos_in):
    return m.measure_update(vc, vcm, T(dist2), T(cos_in))


def _all_diffuse_weights(cam, x1, n1, x2, n2, x3, n3, area):
    """Recursive weights of the 4 techniques of the path cam -> x1 -> x2
    -> x3 (light), all diffuse, one emitter, no RR."""
    d01 = _norm(x1 - cam.o)
    d12 = _norm(x2 - x1)
    d23 = _norm(x3 - x2)
    l01 = np.sum((x1 - cam.o) ** 2)
    l12 = np.sum((x2 - x1) ** 2)
    l23 = np.sum((x3 - x2) ** 2)

    # eye walk: cam -> x1 -> x2 -> x3
    vc, vcm = m.eye_walk_init(cam.n_light, T(cam.t1_pdf(d01)))
    vc, vcm = _measure(vc, vcm, l01, abs(_cos(n1, -d01)))
    vc1, vcm1 = vc, vcm
    vc, vcm = _bounce(vc, vcm, abs(_cos(n1, d12)), _cospdf(n1, d12),
                      _cospdf(n1, -d01))
    vc, vcm = _measure(vc, vcm, l12, abs(_cos(n2, -d12)))
    vc2, vcm2 = vc, vcm
    vc, vcm = _bounce(vc, vcm, abs(_cos(n2, d23)), _cospdf(n2, d23),
                      _cospdf(n2, -d12))
    vc, vcm = _measure(vc, vcm, l23, abs(_cos(n3, -d23)))

    w_s0 = float(m.weight_s0(T(1.0 / area), INV_TWOPI, vc, vcm))

    # s=1 NEE at eye vertex x2
    connect_pdf_w = (1.0 / area) * l23 / abs(_cos(n3, -d23))
    eye_cur_rev_pdf_a = _cos(n2, d23) / l23 * INV_TWOPI
    w_s1 = float(m.weight_s1(T(_cospdf(n2, d23)), T(connect_pdf_w),
                             T(eye_cur_rev_pdf_a), T(_cospdf(n2, -d12)),
                             vc2, vcm2))

    # light walk: x3 -> x2 -> x1
    emission_pdf = INV_TWOPI * (1.0 / area)
    vc_l, vcm_l = m.light_walk_init(T(_cos(n3, -d23)), T(emission_pdf),
                                    T(1.0 / area))
    vc_l, vcm_l = _measure(vc_l, vcm_l, l23, abs(_cos(n2, d23)))
    vcl2, vcml2 = vc_l, vcm_l
    vc_l, vcm_l = _bounce(vc_l, vcm_l, abs(_cos(n2, -d12)),
                          _cospdf(n2, -d12), _cospdf(n2, d23))
    vc_l, vcm_l = _measure(vc_l, vcm_l, l12, abs(_cos(n1, d12)))

    # t=1 splat of light vertex x1
    reverse_pdf_a = cam.t1_pdf(d01) * _g(cam.o, x1, n1)
    w_t1 = float(m.weight_t1(T(reverse_pdf_a), cam.n_light,
                             T(_cospdf(n1, d12)), vc_l, vcm_l))

    # s=2, t=2 connection: eye x1 <-> light x2
    light_rev_a = _cospdf(n1, d12) * _cos(n2, -d12) / l12
    eye_rev_a = _cospdf(n2, -d12) * _cos(n1, d12) / l12
    w_c = float(m.weight_connect(T(light_rev_a), T(_cospdf(n2, d23)),
                                 vcl2, vcml2, T(eye_rev_a),
                                 T(_cospdf(n1, -d01)), vc1, vcm1))
    return w_s0, w_s1, w_c, w_t1


def _all_diffuse_direct(cam, x1, n1, x2, n2, x3, n3, area):
    """Direct balance weights: products of area-measure pdfs."""
    q_cam = cam.q_cam(x1, n1)
    q_e12 = _cospdf(n1, x2 - x1) * _g(x1, x2, n2)
    q_e23 = _cospdf(n2, x3 - x2) * _g(x2, x3, n3)
    q_pos = 1.0 / area
    q_ldir = INV_TWOPI * _g(x3, x2, n2)
    q_l21 = _cospdf(n2, x1 - x2) * _g(x2, x1, n1)
    q = np.array([
        q_cam * q_e12 * q_e23,   # s=0, t=4
        q_cam * q_e12 * q_pos,   # s=1, t=3
        q_cam * q_pos * q_ldir,  # s=2, t=2
        q_pos * q_ldir * q_l21,  # s=3, t=1
    ])
    return q / q.sum()


GEOM = dict(
    x1=np.array([0.4, -0.3, 3.1]), n1=_norm([0.15, 0.25, -1.0]),
    x2=np.array([1.8, 0.9, 2.2]), n2=_norm([-0.7, -0.2, -0.6]),
    x3=np.array([0.3, 2.4, 1.5]), n3=_norm([0.3, -1.0, 0.1]),
)


def _make_cam():
    return Cam(o=[0.0, 0.0, 0.0], forward=[0.0, 0.0, 1.0], vnpd=55.4,
               n_light=64 * 64)


def test_all_diffuse_weights_match_direct_and_sum_to_one():
    cam = _make_cam()
    w = np.array(_all_diffuse_weights(cam, area=0.7, **GEOM))
    w_direct = _all_diffuse_direct(cam, area=0.7, **GEOM)
    assert (w > 0).all() and (w_direct > 0).all()
    np.testing.assert_allclose(w, w_direct, rtol=2e-4)
    assert abs(w.sum() - 1.0) < 5e-4


def test_invariant_catches_injected_recursion_error(monkeypatch):
    """Dropping the vcm term of Eq. 35 from the vc recursion must break
    the invariant."""
    def broken(vc, vcm, abs_cos_out, pdf_w, prev_rev_pdf_w, delta):
        vc_bad = abs_cos_out / pdf_w * (prev_rev_pdf_w * vc)
        inv = 1.0 / pdf_w
        return vc_bad, torch.where(delta, torch.zeros_like(inv), inv)

    monkeypatch.setattr(m, "bounce_update", broken)
    w = np.array(_all_diffuse_weights(_make_cam(), area=0.7, **GEOM))
    assert abs(w.sum() - 1.0) > 1e-2


@pytest.mark.parametrize("area", [0.7, 0.05])
def test_delta_path_weights_sum_to_one(area):
    """cam -> mirror -> diffuse -> light: only s=0 and s=1 exist (delta
    vertices kill connections and splats); Eqs. 53-54 make the two
    surviving weights sum to one and match the direct ratio."""
    cam = _make_cam()
    x1 = np.array([0.4, -0.3, 3.1])
    n1 = _norm([0.1, 0.2, -1.0])
    d01 = _norm(x1 - cam.o)
    d12 = d01 - 2.0 * np.dot(d01, n1) * n1   # mirror reflection
    x2 = x1 + 1.7 * d12
    n2 = _norm(-d12 + np.array([0.2, -0.1, 0.15]))
    x3 = x2 + 1.4 * n2 + np.array([0.3, -0.2, 0.1])
    n3 = _norm(x2 - x3 + np.array([0.1, 0.05, -0.1]))
    d23 = _norm(x3 - x2)
    assert _cos(n2, d23) > 0 and _cos(n3, -d23) > 0
    l01 = np.sum((x1 - cam.o) ** 2)
    l12 = np.sum((x2 - x1) ** 2)
    l23 = np.sum((x3 - x2) ** 2)

    # eye walk with the delta bounce at x1 (pdf 1, reverse pdf 1)
    vc, vcm = m.eye_walk_init(cam.n_light, T(cam.t1_pdf(d01)))
    vc, vcm = _measure(vc, vcm, l01, abs(_cos(n1, -d01)))
    vc, vcm = _bounce(vc, vcm, abs(_cos(n1, d12)), 1.0, 1.0, TRUE)
    vc, vcm = _measure(vc, vcm, l12, abs(_cos(n2, -d12)))
    vc2, vcm2 = vc, vcm
    vc, vcm = _bounce(vc, vcm, abs(_cos(n2, d23)), _cospdf(n2, d23),
                      _cospdf(n2, -d12))
    vc, vcm = _measure(vc, vcm, l23, abs(_cos(n3, -d23)))
    w_s0 = float(m.weight_s0(T(1.0 / area), INV_TWOPI, vc, vcm))

    connect_pdf_w = (1.0 / area) * l23 / abs(_cos(n3, -d23))
    eye_cur_rev_pdf_a = _cos(n2, d23) / l23 * INV_TWOPI
    w_s1 = float(m.weight_s1(T(_cospdf(n2, d23)), T(connect_pdf_w),
                             T(eye_cur_rev_pdf_a), T(_cospdf(n2, -d12)),
                             vc2, vcm2))

    q_e23 = _cospdf(n2, d23) * _g(x2, x3, n3)
    q_pos = 1.0 / area
    np.testing.assert_allclose(
        [w_s0, w_s1], [q_e23 / (q_e23 + q_pos), q_pos / (q_e23 + q_pos)],
        rtol=2e-4)
    assert abs(w_s0 + w_s1 - 1.0) < 5e-4
