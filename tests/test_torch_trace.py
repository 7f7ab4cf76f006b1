"""The plain versions of K1 (closest hit) and K2 (any hit) and the
live-lane compaction of the port against the reference package's Pallas
kernels, run as the reference's own tests run them on the CPU
(interpret=True)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.ops import compaction as jcomp
from bpt_tpu.ops import pallas_sweep, pallas_trace
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.accel import api
from bpt_tpu_torch.ops import compaction as tcomp
from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_plain
from bpt_tpu_torch.ops.trace_closest import closest_hit, closest_hit_plain
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays

N = 2048


@pytest.fixture(scope="module")
def scenes():
    js, _, _ = jax_cbox(32, 32, right_object="glass_sphere", sphere_subdiv=3)
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    return js, ts


def _rays(seed=0, n=N, live_frac=0.8, segment=False):
    """Rays from inside the box and from the camera, random directions,
    with dead lanes.  segment=True gives finite windows (shadow rays)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95],
                   (n, 3)).astype(np.float32)
    o[: n // 4] = [0.0, 1.0, 3.8]
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[: n // 4, 2] = -np.abs(d[: n // 4, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    live = rs.rand(n) < live_frac
    mn = np.full(n, 1e-8, np.float32)
    far = rs.uniform(0.1, 3.0, n).astype(np.float32) if segment else np.inf
    mx = np.where(live, far, -1.0).astype(np.float32)
    return o, d, mn, mx, live


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_closest_equal(jt, jtri, ju, jv, tt, ttri, tu, tv, live,
                          uv_atol=1e-5):
    """tri equal except on ties (the two candidates' t within 1e-6
    relative); t/u/v rtol 1e-6 where tri agrees.

    The interpret-mode reference runs on XLA:CPU, which may contract
    multiply-adds, while the port rounds every operation (as its CUDA
    kernel does, built with -fmad=false).  The differences are absolute,
    from the o - v0 products, so t gets atol 1e-7 (measured 1.08e-6
    relative at t = 0.045), and u, v get atol 1e-5: camera rays hitting
    small sphere triangles 3.3 units away (|det| ~ 1e-3) amplify a few
    ulp of the numerator to 4e-6 (measured).  `uv_atol` is that atol, for
    callers with smaller triangles."""
    same = ttri == jtri
    hit_both = np.isfinite(tt) & np.isfinite(jt)
    gap = np.abs(np.where(hit_both, tt, 0.0) - np.where(hit_both, jt, 0.0))
    ties = ~same & hit_both & (gap <= 1e-6 * np.abs(jt))
    assert np.all(same | ties), np.nonzero(~(same | ties))
    assert ties.sum() <= 2
    np.testing.assert_allclose(tt[same], jt[same], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tu[same], ju[same], rtol=1e-6, atol=uv_atol)
    np.testing.assert_allclose(tv[same], jv[same], rtol=1e-6, atol=uv_atol)
    assert np.all(ttri[~live] == -1) and np.all(np.isinf(tt[~live]))
    assert np.all(tu[~live] == 0) and np.all(tv[~live] == 0)


def test_closest_plain_matches_pallas_compact(scenes):
    js, ts = scenes
    o, d, mn, mx, live = _rays(1)
    h = pallas_trace.trace_closest_compact(js.treelets, *_jax(o, d, mn, mx),
                                           interpret=True)
    got = closest_hit_plain(ts.treelets, *_torch(o, d, mn, mx))
    assert (got[1] >= 0).sum() > N // 2
    _assert_closest_equal(*(np.asarray(x) for x in (h.t, h.tri, h.u, h.v)),
                          *(x.numpy() for x in got), live)


def test_closest_wrapper_routes_cpu_to_plain(scenes):
    _, ts = scenes
    args = _torch(*_rays(2)[:4])
    launches = closest_hit.launches
    a = closest_hit(ts.treelets, *args)
    b = closest_hit_plain(ts.treelets, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert closest_hit.launches == launches


def test_any_plain_matches_pallas_sweep(scenes):
    js, ts = scenes
    o, d, mn, mx, live = _rays(3, live_frac=0.3, segment=True)
    occ = pallas_sweep.trace_any_sweep(js.treelets_any, *_jax(o, d, mn, mx),
                                       interpret=True)
    got = any_hit_plain(ts.treelets_any, *_torch(o, d, mn, mx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(occ))
    assert 0 < int(got.sum()) < int(live.sum())
    assert not got.numpy()[~live].any()
    launches = any_hit.launches
    assert torch.equal(any_hit(ts.treelets_any, *_torch(o, d, mn, mx)), got)
    assert any_hit.launches == launches


KINDS = [None, "ray", "segment"]
LIVE = [0.0, 0.07, 0.5, 1.0]


def _bounds(js, ts):
    jb = (jnp.min(js.treelets.bmin, axis=0), jnp.max(js.treelets.bmax, axis=0))
    return jb, api.scene_bounds(ts.treelets)


@pytest.mark.parametrize("live_frac", LIVE)
@pytest.mark.parametrize("kind", KINDS)
def test_compaction_layout_matches_reference(scenes, kind, live_frac):
    """Below the reference's chunking threshold it sorts one chunk, so
    the two compacted layouts must be identical, cluster keys included."""
    js, ts = scenes
    o, d, mn, mx, live = _rays(4, n=3000, live_frac=live_frac,
                               segment=kind == "segment")
    jb, tb = _bounds(js, ts)
    jkw = {} if kind is None else dict(bounds=jb, kind=kind)
    tkw = {} if kind is None else dict(bounds=tb, kind=kind)
    jo, jd, jmn, jmx, jplan = jcomp.compact_rays(*_jax(o, d, mn, mx), **jkw)
    to, td, tmn, tmx, tplan = tcomp.compact_rays(*_torch(o, d, mn, mx), **tkw)
    np.testing.assert_array_equal(tplan.orig_idx.numpy(),
                                  np.asarray(jplan.orig_idx))
    np.testing.assert_array_equal(tplan.valid.numpy(), live)
    for j, t in ((jo, to), (jd, td), (jmn, tmn), (jmx, tmx)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    n_live = int(live.sum())
    assert bool((tmx[:n_live] >= tmn[:n_live]).all())
    assert bool((tmx[n_live:] < tmn[n_live:]).all())


@pytest.mark.parametrize("kind", KINDS)
def test_uncompact_restores_live_lanes(scenes, kind):
    js, ts = scenes
    o, d, mn, mx, live = _rays(5, n=1500, live_frac=0.37)
    _, tb = _bounds(js, ts)
    kw = {} if kind is None else dict(bounds=tb, kind=kind)
    *_, plan = tcomp.compact_rays(*_torch(o, d, mn, mx), **kw)
    payload = torch.arange(1500, dtype=torch.float32)[plan.orig_idx]
    back = tcomp.uncompact(payload, plan, -1.0).numpy()
    exp = np.where(live, np.arange(1500), -1).astype(np.float32)
    np.testing.assert_array_equal(back, exp)
    flags = torch.ones(1500, dtype=torch.bool)
    assert np.array_equal(tcomp.uncompact(flags, plan, False).numpy(), live)


@pytest.mark.parametrize("live_frac", [0.07, 0.6])
def test_compacted_closest_matches_reference_route(scenes, live_frac):
    """api.trace_closest (cluster-keyed compaction + K1's plain version)
    == the reference's compaction + Pallas compact kernel, uncompacted."""
    js, ts = scenes
    o, d, mn, mx, live = _rays(6, live_frac=live_frac)
    jb, _ = _bounds(js, ts)
    oc, dc, mnc, mxc, plan = jcomp.compact_rays(*_jax(o, d, mn, mx),
                                                bounds=jb, kind="ray")
    h = pallas_trace.trace_closest_compact(js.treelets, oc, dc, mnc, mxc,
                                           interpret=True)
    ref = jcomp.uncompact_many((h.t, h.tri, h.u, h.v), plan,
                               (jnp.inf, -1, 0.0, 0.0))
    got = api.trace_closest(ts, *_torch(o, d, mn, mx))
    _assert_closest_equal(*(np.asarray(x) for x in ref),
                          *(x.numpy() for x in got[:4]), live)
    np.testing.assert_array_equal(got.valid.numpy(), got.tri.numpy() >= 0)


@pytest.mark.parametrize("live_frac", [0.07, 0.6])
def test_compacted_any_matches_reference_route(scenes, live_frac):
    js, ts = scenes
    o, d, mn, mx, live = _rays(7, live_frac=live_frac, segment=True)
    jb, _ = _bounds(js, ts)
    oc, dc, mnc, mxc, plan = jcomp.compact_rays(*_jax(o, d, mn, mx),
                                                bounds=jb)
    occ = pallas_sweep.trace_any_sweep(js.treelets_any, oc, dc, mnc, mxc,
                                       interpret=True)
    ref = jcomp.uncompact(occ, plan, False)
    got = api.trace_any(ts, *_torch(o, d, mn, mx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_scalar_windows_broadcast(scenes):
    _, ts = scenes
    o, d, _, _, _ = _rays(8, n=256)
    h = api.trace_closest(ts, *_torch(o, d), 1e-8, float("inf"))
    ref = closest_hit_plain(ts.treelets, *_torch(o, d),
                            torch.full((256,), 1e-8),
                            torch.full((256,), float("inf")))
    assert torch.equal(h.tri, ref[1]) and torch.equal(h.t, ref[0])


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_wrapper_rejects_malformed_input(scenes, bad):
    _, ts = scenes
    o, d, mn, mx = _torch(*_rays(9, n=64)[:4])
    if bad == "dtype":
        o = o.double()
    elif bad == "shape":
        mn = mn[:10]
    else:
        o = torch.stack([o[:, 0], o[:, 1], o[:, 2]], dim=1).t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        closest_hit(ts.treelets, o, d, mn, mx)
    with pytest.raises((TypeError, ValueError)):
        any_hit(ts.treelets, o, d, mn, mx)
