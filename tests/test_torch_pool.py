"""Pooled light transport of the port against the reference package on
the CPU: rng.stream, the walks' pooled arguments (n_light, collect),
connect_pool and render_sample_pool, from the same scene arrays and keys
(the reference routes its XLA tracer here, the port its plain trace
versions).  The setup is tests/test_ring.py's: the Cornell box at 16x16,
a pool of 32 light subpaths, rr_depth 3, 2 samples.

Whole renders are gated on aggregates as tests/test_torch_bdpt.py gates
them (nrays within 1e-3, image mean within 1e-3 relative, at most 2% of
the pixels off by more than 0.1%); deterministic stages to rtol 1e-4."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core import camera as jcam
from bpt_tpu.core import rng as jrng
from bpt_tpu.integrators import bdpt as jb
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.core import camera as tcam
from bpt_tpu_torch.core import rng as trng
from bpt_tpu_torch.integrators import bdpt as tb
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays

W = 16
POOL = 32
CFG = dict(spp=2, rr_depth=3, light_pool=POOL)


def _gate(a, b, na, nb):
    denom = np.maximum(np.abs(b), 1e-3)
    frac_off = float((np.abs(a - b) / denom > 1e-3).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(
        float(b.mean()), 1e-9)
    assert abs(na - nb) / max(nb, 1) <= 1e-3, (na, nb)
    assert mean_rel <= 1e-3, (a.mean(), b.mean())
    assert frac_off <= 0.02, frac_off


def _t(a):
    return torch.from_numpy(np.array(a))


def _slots(j):
    return tb.LightVertexSlots(*(_t(a) for a in j))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small tensors run as fast on one, and
    the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """Both packages' box from the same arrays, and every reference
    output the tests compare with, computed once: the pool's light walk
    and the collecting eye walk of one sample (seed 11), connect_pool on
    them, and the pooled render of CFG["spp"] samples."""
    js, _, jc = jax_cbox(W, W)
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    tc = tcam.Camera.make(jc.o, jc.at, jc.up, jc.fov, jc.width, jc.height)
    cfg_j = jb.BDPTConfig(W, W, **CFG)
    jcc = jc.device_constants()
    pix = jnp.arange(W * W, dtype=jnp.int32)
    pids = jnp.arange(POOL, dtype=jnp.int32)
    key = jax.random.key(11)
    lkeys = jrng.lane_keys(key, pix)
    pkeys = jrng.lane_keys(jrng.stream(key, jrng.POOL_WALK), pids)
    light = jb.light_subpath_walk(js, jcc, cfg_j, pkeys, POOL,
                                  jnp.ones((POOL,), bool),
                                  n_light=float(POOL))
    jitter = jrng.uniform2(jrng.lane_fold(lkeys, jrng.PIXEL_JITTER))
    _, d = jcam.generate_rays(jcc, W, W, pix, jitter)
    eye = jb.eye_subpath_walk(js, jcc, cfg_j, lkeys, d, None,
                              n_light=float(POOL), collect=True)
    connect = {c: jb.connect_pool(js, cfg_j, eye[2], light[0], POOL, chunk=c)
               for c in (None, 5)}

    sample = jax.jit(lambda k: jb.render_sample_pool(js, jcc, cfg_j, k, pix,
                                                     pids))
    fb = jnp.zeros((W * W, 3), jnp.float32)
    nrays = 0
    for s in range(CFG["spp"]):
        fb_s, nr = sample(jax.random.fold_in(key, s))
        fb, nrays = fb + fb_s, nrays + int(nr)
    return dict(js=js, jc=jc, ts=ts, tc=tc, d=d, light=light, eye=eye,
                connect=connect, render=(np.asarray(fb), nrays))


def _cfg():
    return tb.BDPTConfig(W, W, **CFG)


def _keys(seed=11):
    key = trng.key(seed, device="cpu")
    pix = torch.arange(W * W, dtype=torch.int32)
    pids = torch.arange(POOL, dtype=torch.int32)
    return key, pix, pids


@pytest.mark.parametrize("seed,ids", [(0, ()), (11, (400,)),
                                      (2**30 + 3, (400, 7)),
                                      (5, (1, 2, 3, 2**31 - 5))])
def test_stream_bits_match_reference(seed, ids):
    got = trng.stream(trng.key(seed, device="cpu"), *ids)
    want = jax.random.key_data(jrng.stream(jax.random.key(seed), *ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pids = np.arange(37, dtype=np.int32)
    got = trng.lane_keys(got, torch.from_numpy(pids))
    want = jax.random.key_data(jrng.lane_keys(
        jrng.stream(jax.random.key(seed), *ids), jnp.asarray(pids)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_slots_match(t_slots, j_slots):
    np.testing.assert_array_equal(t_slots.valid.numpy(),
                                  np.asarray(j_slots.valid))
    np.testing.assert_array_equal(t_slots.tri.numpy(),
                                  np.asarray(j_slots.tri))
    np.testing.assert_array_equal(t_slots.mat_id.numpy(),
                                  np.asarray(j_slots.mat_id))
    for name in ("p", "ns", "wo", "throughput", "vcm", "vc", "rr", "u",
                 "v"):
        np.testing.assert_allclose(
            getattr(t_slots, name).numpy(),
            np.asarray(getattr(j_slots, name)), rtol=1e-4, atol=1e-5,
            err_msg=name)


def test_pool_light_walk_matches_reference(ref):
    """The pool's light walk keyed by global pool index with n_light =
    the pool size: slots, t=1 splats (normalised by the pool) and ray
    count."""
    key, _, pids = _keys()
    pkeys = trng.lane_keys(trng.stream(key, trng.POOL_WALK), pids)
    slots, pix, rgb, nr = tb.light_subpath_walk(
        ref["ts"], ref["tc"].device_constants("cpu"), _cfg(), pkeys, POOL,
        torch.ones((POOL,), dtype=torch.bool), n_light=float(POOL))
    j_slots, j_pix, j_rgb, j_nr = ref["light"]
    assert int(nr) == int(j_nr) > POOL
    _assert_slots_match(slots, j_slots)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(j_pix))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), rtol=1e-4,
                               atol=1e-6)
    assert float(rgb.sum()) > 0.0


def test_collecting_eye_walk_matches_reference(ref):
    """eye_subpath_walk with n_light and collect: the s=0 + NEE radiance,
    the ray count and the collected eye vertices."""
    key, pix, _ = _keys()
    li, nr, eye = tb.eye_subpath_walk(
        ref["ts"], ref["tc"].device_constants("cpu"), _cfg(),
        trng.lane_keys(key, pix), _t(ref["d"]), n_light=float(POOL),
        collect=True)
    j_li, j_nr, j_eye = ref["eye"]
    assert int(nr) == int(j_nr)
    _assert_slots_match(eye, j_eye)
    np.testing.assert_allclose(li.numpy(), np.asarray(j_li), rtol=1e-4,
                               atol=1e-6)


def test_eye_walk_defaults_count_w_times_h_light_paths(ref):
    """Without n_light the walk's MIS state counts W*H light paths, so
    the radiance is the path_trace-style walk of before, and collect adds
    the vertices without changing the radiance."""
    key, pix, _ = _keys()
    args = (ref["ts"], ref["tc"].device_constants("cpu"), _cfg(),
            trng.lane_keys(key, pix), _t(ref["d"]))
    li, nr = tb.eye_subpath_walk(*args)
    li_w, nr_w, _ = tb.eye_subpath_walk(*args, n_light=float(W * W),
                                        collect=True)
    assert int(nr) == int(nr_w)
    np.testing.assert_array_equal(li.numpy(), li_w.numpy())


@pytest.mark.parametrize("chunk", [None, 5], ids=["ref_budget", "padded"])
def test_connect_pool_matches_reference(ref, chunk):
    """connect_pool on the reference's walk outputs: with the chunk the
    reference's budget gives (the whole 64-vertex pool shard in one
    trace) and with chunks of 5 vertices, whose last chunk the reference
    pads and the port slices short."""
    l_e, b = ref["eye"][2].valid.shape
    want_chunk = min(2 * POOL, 458752 // (l_e * b)) if chunk is None \
        else chunk
    li, nr = tb.connect_pool(ref["ts"], _cfg(), _slots(ref["eye"][2]),
                             _slots(ref["light"][0]), POOL,
                             chunk=want_chunk)
    j_li, j_nr = ref["connect"][chunk]
    assert int(nr) == int(j_nr) > 0
    np.testing.assert_allclose(li.numpy(), np.asarray(j_li), rtol=1e-4,
                               atol=1e-6)
    assert float(li.sum()) > 0.0


def test_connect_pool_sums_do_not_depend_on_the_chunk(ref):
    """The default chunk (the pool in one trace here), chunks of 5 and of
    one vertex give the same sums up to float order and the same rays."""
    args = (ref["ts"], _cfg(), _slots(ref["eye"][2]),
            _slots(ref["light"][0]), POOL)
    li, nr = tb.connect_pool(*args)
    for chunk in (5, 1):
        li_c, nr_c = tb.connect_pool(*args, chunk=chunk)
        assert int(nr_c) == int(nr)
        np.testing.assert_allclose(li_c.numpy(), li.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_render_sample_pool_matches_reference(ref):
    """CFG["spp"] pooled samples keyed fold_in(key, s), summed: image and
    ray count against the reference's render_sample_pool."""
    key, pix, pids = _keys()
    cc = ref["tc"].device_constants("cpu")
    fb = torch.zeros((W * W, 3))
    nrays = 0
    for s in range(CFG["spp"]):
        fb_s, nr = tb.render_sample_pool(ref["ts"], cc, _cfg(),
                                         trng.fold_in(key, s), pix, pids)
        fb, nrays = fb + fb_s, nrays + int(nr)
    j_fb, j_nrays = ref["render"]
    fb = fb.numpy()
    assert np.isfinite(fb).all() and (fb >= 0).all() and fb.mean() > 0
    _gate(fb, j_fb, nrays, j_nrays)


def test_pool_shards_and_lane_keys_do_not_change_the_sample(ref):
    """Pool keys follow the pool index, not the array position: the pool
    given as two shards connected in two passes (a rotate_fn that hands
    on the other shard), or in reversed order, gives the one-pass sample;
    lkeys=lane_keys(key, pixels) gives the sample without them."""
    key, pix, pids = _keys()
    cc = ref["tc"].device_constants("cpu")
    one, n1 = tb.render_sample_pool(ref["ts"], cc, _cfg(), key, pix, pids)
    rev, n2 = tb.render_sample_pool(ref["ts"], cc, _cfg(), key, pix,
                                    pids.flip(0))
    lk, n3 = tb.render_sample_pool(ref["ts"], cc, _cfg(), key, pix, pids,
                                   lkeys=trng.lane_keys(key, pix))
    assert int(n1) == int(n2) == int(n3)
    np.testing.assert_array_equal(lk.numpy(), one.numpy())
    np.testing.assert_allclose(rev.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-7)

    # Two shards: the walk of shard 0 renders, the ring hands on shard 1.
    half = POOL // 2
    pkeys = trng.lane_keys(trng.stream(key, trng.POOL_WALK), pids[half:])
    other = tb.light_subpath_walk(ref["ts"], cc, _cfg(), pkeys, half,
                                  torch.ones((half,), dtype=torch.bool),
                                  n_light=float(POOL))
    handed = []

    def rotate(slots):
        handed.append(slots.valid.shape)
        return other[0]

    fb0, nr0 = tb.render_sample_pool(ref["ts"], cc, _cfg(), key, pix,
                                     pids[:half], rotate_fn=rotate,
                                     n_ring=2)
    assert handed == [(CFG["rr_depth"] - 1, half)]
    # The framebuffer of shard 0 lacks shard 1's t=1 splats and rays.
    fb = fb0 + torch.zeros((W * W + 1, 3)).index_add_(
        0, other[1].reshape(-1).long(), other[2].reshape(-1, 3))[:W * W]
    assert int(nr0) + int(other[3]) == int(n1)
    np.testing.assert_allclose(fb.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_render_image_ignores_light_pool_as_the_reference(ref):
    """render_image with light_pool > 0 renders per-pixel BDPT, as the
    reference's does (it never reads light_pool): the same image as
    without the pool, and the reference's render of the config.  Replaces
    the test that the port refused this config."""
    cfg = dict(spp=2, rr_depth=3, light_pool=16)
    ti, tn = tb.render_image(ref["ts"], ref["tc"], tb.BDPTConfig(W, W, **cfg),
                             seed=0)
    t0, n0 = tb.render_image(ref["ts"], ref["tc"],
                             tb.BDPTConfig(W, W, spp=2, rr_depth=3), seed=0)
    ji, jn = jb.render_image(ref["js"], ref["jc"],
                             jb.BDPTConfig(W, W, **cfg), seed=0)
    assert tn == n0
    np.testing.assert_array_equal(ti.numpy(), t0.numpy())
    _gate(ti.numpy(), np.asarray(ji), tn, jn)


def test_pool_estimator_consistency():
    """Pooled and per-pixel BDPT estimate the same transport: the image
    means of 4 seeds each agree within 4 standard errors or 5%
    (tests/test_ring.py::test_pool_estimator_consistency on the port)."""
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    scene, _, cam = cornell_box_scene(W, W, device="cpu")
    cc = cam.device_constants("cpu")
    r, spp = 4, 8
    cfg_pool = tb.BDPTConfig(W, W, spp=spp, rr_depth=3, light_pool=POOL)
    _, pix, pids = _keys()
    means_pool = []
    for i in range(r):
        key = trng.key(50 + i, device="cpu")
        fb = sum(tb.render_sample_pool(scene, cc, cfg_pool,
                                       trng.fold_in(key, s), pix, pids)[0]
                 for s in range(spp))
        means_pool.append(float(fb.double().mean()))
    cfg_std = tb.BDPTConfig(W, W, spp=spp, rr_depth=3)
    means_std = [float(tb.render_image(scene, cam, cfg_std, seed=70 + i,
                                       spp_chunk=spp)[0].double().mean())
                 for i in range(r)]
    mp, ms = np.mean(means_pool), np.mean(means_std)
    se = np.sqrt(np.var(means_pool) / r + np.var(means_std) / r)
    assert abs(mp - ms) < max(4.0 * se, 0.05 * ms), (mp, ms, se)
