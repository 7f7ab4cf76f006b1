"""The ported path tracer (integrators/path.py) against the reference
package on the CPU, from the same scene arrays and seed: the
direct-illumination estimator on one batch of interactions (rtol 1e-4 /
atol 1e-5), and whole renders with the ray count exact and the image
through the aggregate gate of tests/test_torch_bdpt.py::_gate.  Renders
use 2 jittered samples, as tests/test_torch_bdpt.py does."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import rng as jrng
from bpt_tpu.integrators import common as jcommon
from bpt_tpu.integrators import path as jp
from bpt_tpu_torch.accel.api import Hit as THit
from bpt_tpu_torch.core import rng as trng
from bpt_tpu_torch.integrators import common as tcommon
from bpt_tpu_torch.integrators import path as tp
from bpt_tpu_torch.ops.trace_closest import closest_hit_plain
from test_torch_bdpt import (  # noqa: F401  (_one_thread: a fixture)
    _gate, _one_thread, _pair)

W = 16


@pytest.fixture(scope="module")
def pair():
    """Both packages' glass box from the reference's arrays: (js, jc, ts,
    tc)."""
    return _pair(W)


def test_direct_illumination_matches_reference(pair):
    """Emitter and BSDF samples at 1,024 interactions inside the box,
    a quarter of the lanes inactive."""
    js, _, ts, _ = pair
    n = 1024
    rs = np.random.RandomState(6)
    o = rs.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(
        np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t, tri, u, v = closest_hit_plain(
        ts.treelets, torch.from_numpy(o), torch.from_numpy(d),
        torch.full((n,), 1e-8), torch.full((n,), float("inf")))
    valid = tri >= 0
    ti = tcommon.make_interaction(ts, torch.from_numpy(d), THit(
        t=t, tri=tri, u=u, v=v, valid=valid))
    ji = jcommon.make_interaction(js, jnp.asarray(d), jcommon.Hit(
        t=jnp.asarray(t.numpy()), tri=jnp.asarray(tri.numpy()),
        u=jnp.asarray(u.numpy()), v=jnp.asarray(v.numpy()),
        valid=jnp.asarray(valid.numpy())))
    active = valid.numpy() & (rs.rand(n) < 0.75)
    ids = np.arange(n, dtype=np.int32)
    jk = jrng.lane_keys(jax.random.key(4), jnp.asarray(ids))
    tk = trng.lane_keys(trng.key(4, device="cpu"), torch.from_numpy(ids))
    cfg = dict(spp=1, emitter_samples=2, bsdf_samples=1)
    jl = jax.jit(jp._direct_illumination, static_argnums=1)(
        js, jp.PathConfig(W, W, **cfg), jk, ji, jnp.asarray(active))
    tl = tp._direct_illumination(ts, tp.PathConfig(W, W, **cfg), tk, ti,
                                 torch.from_numpy(active))
    jl = np.asarray(jl)
    assert (jl[active].max(axis=-1) > 0).sum() > 50
    assert not tl[~torch.from_numpy(active)].any()
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-5)


CASES = {
    "explicit": dict(max_bounces=4),
    "explicit_mis": dict(max_bounces=4, bsdf_samples=1),
    "implicit": dict(is_explicit=False, max_depth=3),
    "explicit_rr": dict(max_bounces=6, rr_depth=2, rr_prob=0.6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_image_path_matches_reference(pair, case):
    js, jc, ts, tc = pair
    cfg = dict(spp=2, **CASES[case])
    ji, jn = jp.render_image_path(js, jc, jp.PathConfig(W, W, **cfg),
                                  seed=1)
    ti, tn = tp.render_image_path(ts, tc, tp.PathConfig(W, W, **cfg),
                                  seed=1)
    ti = ti.numpy()
    assert ti.shape == (W, W, 3) and np.isfinite(ti).all()
    assert tn == int(jn)
    _gate(ti, np.asarray(ji), tn, int(jn))


def test_loops_that_end_early_change_nothing(pair, monkeypatch):
    """The re-roll and bounce loops stop once no lane is left in them;
    with that test forced true they run to the end, and the image and
    the ray count are bit-equal."""
    _, _, ts, tc = pair
    calls = []
    any_live = tp._any_live

    def counting(mask):
        out = any_live(mask)
        calls.append(out)
        return out

    for cfg in (tp.PathConfig(W, W, spp=2, max_bounces=8, rr_depth=2,
                              rr_prob=0.5),
                tp.PathConfig(W, W, spp=2, is_explicit=False, max_depth=6)):
        monkeypatch.setattr(tp, "_any_live", counting)
        a, na = tp.render_image_path(ts, tc, cfg, seed=3)
        monkeypatch.setattr(tp, "_any_live", lambda mask: True)
        b, nb = tp.render_image_path(ts, tc, cfg, seed=3)
        assert na == nb
        assert torch.equal(a, b)
    assert False in calls  # a loop did end early


def test_samples_per_batch_keeps_the_estimate(pair):
    _, _, ts, tc = pair
    cfg = tp.PathConfig(W, W, spp=4, max_bounces=3)
    cam_consts, key = tc.device_constants("cpu"), trng.key(2, "cpu")
    a, na = tp.render_chunk_path(ts, cam_consts, cfg, key, 4)
    b, nb = tp.render_chunk_path(ts, cam_consts, cfg, key, 4,
                                 samples_per_batch=2)
    assert int(na) == int(nb)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        tp.render_chunk_path(ts, cam_consts, cfg, key, 3,
                             samples_per_batch=2)


def test_config_depths():
    assert tp.PathConfig(4, 4, 1).n_steps == 32
    assert tp.PathConfig(4, 4, 1, is_explicit=False).n_steps == 0
    assert tp.PathConfig(4, 4, 1, max_depth=3, is_explicit=False).n_steps \
        == 3
    assert tp.MAX_REROLLS == jp.MAX_REROLLS
