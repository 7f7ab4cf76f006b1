"""The ported normal / simple / ao / ro integrators (integrators/misc.py)
against the reference package on the CPU, from the same scene arrays and
seed: the first light exactly, each integrator as a whole render (16x16,
2 jittered samples) with the ray count exact and the image through the
aggregate gate of tests/test_torch_bdpt.py::_gate."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bpt_tpu.integrators import misc as jm
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.core import camera as tcam
from bpt_tpu_torch.integrators import misc as tm
from bpt_tpu_torch.scene.procedural import cornell_box_scene
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays
from test_torch_bdpt import (  # noqa: F401  (_one_thread: a fixture)
    _gate, _one_thread)

W = 16


@pytest.fixture(scope="module")
def pair():
    js, jmeta, jc = jax_cbox(W, W, right_object="glass_sphere",
                             sphere_subdiv=3)
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    _, tmeta, _ = cornell_box_scene(W, W, device="cpu",
                                    right_object="glass_sphere",
                                    sphere_subdiv=3)
    tc = tcam.Camera.make(jc.o, jc.at, jc.up, jc.fov, jc.width, jc.height)
    return js, jmeta, jc, ts, tmeta, tc


def test_first_light_matches_reference(pair):
    """The reference's render_image_misc takes the first emitter's shape
    center and radiance (misc.py:120-126)."""
    js, jmeta, _, ts, tmeta, _ = pair
    pos, intensity = tm.first_light(ts, tmeta)
    sid = int(np.asarray(js.emitters.shape_id)[0])
    np.testing.assert_array_equal(pos.numpy(), jmeta.shapes_center[sid])
    np.testing.assert_array_equal(intensity.numpy(),
                                  np.asarray(js.emitters.radiance[0]))
    assert pos.dtype == intensity.dtype == torch.float32


@pytest.mark.parametrize("integrator", ["normal", "simple", "ao", "ro"])
def test_render_image_misc_matches_reference(pair, integrator):
    js, jmeta, jc, ts, tmeta, tc = pair
    ji, jn = jm.render_image_misc(
        js, jmeta, jc, jm.MiscConfig(W, W, 2, integrator=integrator), seed=1)
    ti, tn = tm.render_image_misc(
        ts, tmeta, tc, tm.MiscConfig(W, W, 2, integrator=integrator), seed=1)
    ti = ti.numpy()
    assert ti.shape == (W, W, 3) and np.isfinite(ti).all()
    assert ti.mean() > 0.0
    assert tn == jn == W * W * 2
    _gate(ti, np.asarray(ji), tn, jn)


def test_ro_exponent_and_unknown_integrator(pair):
    """ro's exponent reaches the lobe (a wider lobe gives another image,
    as in the reference), and an unknown integrator raises."""
    js, jmeta, jc, ts, tmeta, tc = pair
    cfg = dict(integrator="ro", exponent=2.0)
    ji, jn = jm.render_image_misc(js, jmeta, jc,
                                  jm.MiscConfig(W, W, 2, **cfg), seed=4)
    ti, tn = tm.render_image_misc(ts, tmeta, tc,
                                  tm.MiscConfig(W, W, 2, **cfg), seed=4)
    _gate(ti.numpy(), np.asarray(ji), tn, jn)
    t30, _ = tm.render_image_misc(ts, tmeta, tc,
                                  tm.MiscConfig(W, W, 2, integrator="ro"),
                                  seed=4)
    assert abs(float(ti.mean()) - float(t30.mean())) > 1e-3
    with pytest.raises(ValueError):
        tm.render_image_misc(ts, tmeta, tc,
                             tm.MiscConfig(W, W, 1, integrator="nope"))
