"""The ported direct-illumination integrator (integrators/direct.py)
against the reference package on the CPU, from the same scene arrays and
seed: the bounding-sphere lights exactly, the analytic sphere test on
random rays, and each of the five strategies as a whole render (16x16,
2 jittered samples), the ray count exact and the image through the
aggregate gate of tests/test_torch_bdpt.py::_gate."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.integrators import direct as jd
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.core import camera as tcam
from bpt_tpu_torch.integrators import direct as td
from bpt_tpu_torch.scene.procedural import cornell_box_scene
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays
from test_torch_bdpt import (  # noqa: F401  (_one_thread: a fixture)
    _gate, _one_thread)

W = 16
STRATEGIES = ["area", "solidAngle", "cosineHemisphere", "bsdf", "mis"]


@pytest.fixture(scope="module")
def pair():
    """(js, jmeta, jc, ts, tmeta, tc): the reference's glass box, the
    port's scene from its arrays and the port's own SceneMeta."""
    js, jmeta, jc = jax_cbox(W, W, right_object="glass_sphere",
                             sphere_subdiv=3)
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    _, tmeta, _ = cornell_box_scene(W, W, device="cpu",
                                    right_object="glass_sphere",
                                    sphere_subdiv=3)
    tc = tcam.Camera.make(jc.o, jc.at, jc.up, jc.fov, jc.width, jc.height)
    return js, jmeta, jc, ts, tmeta, tc


def test_sphere_lights_match_reference(pair):
    js, jmeta, _, ts, tmeta, _ = pair
    for f in ("shapes_center", "shapes_aabb_max"):
        np.testing.assert_array_equal(getattr(tmeta, f), getattr(jmeta, f))
    jl, tl = jd.SphereLights(js, jmeta), td.SphereLights(ts, tmeta)
    np.testing.assert_array_equal(tl.center.numpy(), np.asarray(jl.center))
    np.testing.assert_array_equal(tl.radius.numpy(), np.asarray(jl.radius))
    assert tl.radius.shape == (1,) and float(tl.radius[0]) > 0.0


@pytest.mark.parametrize("max_t", [np.inf, 2.0], ids=["inf", "bounded"])
def test_ray_sphere_hit_matches_reference(max_t):
    rs = np.random.RandomState(3)
    n = 4096
    o = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    r = rs.uniform(0.1, 1.5, n).astype(np.float32)
    jh = jd._ray_sphere_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                            jnp.asarray(r), 1e-8, max_t)
    th = td._ray_sphere_hit(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(c), torch.from_numpy(r), 1e-8,
                            max_t)
    assert 200 < int(th.sum()) < n - 200
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_render_image_direct_matches_reference(pair, strategy):
    js, jmeta, jc, ts, tmeta, tc = pair
    ji, jn = jd.render_image_direct(
        js, jmeta, jc, jd.DirectConfig(W, W, 2, strategy=strategy), seed=1)
    ti, tn = td.render_image_direct(
        ts, tmeta, tc, td.DirectConfig(W, W, 2, strategy=strategy), seed=1)
    ti = ti.numpy()
    assert ti.shape == (W, W, 3) and np.isfinite(ti).all()
    assert ti.mean() > 0.0
    assert tn == jn == W * W * 2
    _gate(ti, np.asarray(ji), tn, jn)


def test_unknown_strategy_raises(pair):
    """The reference's ValueError, also for "emitter", the default that
    load_toml gives a direct scene without samplingStrategy."""
    _, _, _, ts, tmeta, tc = pair
    for strategy in ("emitter", "nope"):
        with pytest.raises(ValueError, match="unknown strategy"):
            td.render_image_direct(ts, tmeta, tc,
                                   td.DirectConfig(W, W, 1, strategy=strategy))
