"""The ported BDPT main path as a whole against the reference package on
the CPU (the reference routes its XLA tracer there, the port its plain
trace versions), from the same scene arrays and seed.

Whole renders are gated on aggregates as tests/onchip_check.py:100-121
gates them, because an ulp tie on a triangle edge can reroute a path:
nrays within 1e-3, image mean within 1e-3 relative, at most 2% of the
pixels off by more than 0.1%."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.accel.api import trace_closest as jax_trace_closest
from bpt_tpu.core import camera as jcam
from bpt_tpu.core import rng as jrng
from bpt_tpu.integrators import bdpt as jb
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.core import camera as tcam
from bpt_tpu_torch.core import rng as trng
from bpt_tpu_torch.integrators import bdpt as tb
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays


GLASS = dict(right_object="glass_sphere", sphere_subdiv=3)


def _pair(w, scene=GLASS):
    """Both packages' Cornell box built from the same arrays by the
    reference's cornell_box_scene(w, w, **scene): the glass box unless
    `scene` says otherwise."""
    js, _, jc = jax_cbox(w, w, **scene)
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    tc = tcam.Camera.make(jc.o, jc.at, jc.up, jc.fov, jc.width, jc.height)
    return js, jc, ts, tc


def _gate(a, b, na, nb):
    denom = np.maximum(np.abs(b), 1e-3)
    frac_off = float((np.abs(a - b) / denom > 1e-3).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(
        float(b.mean()), 1e-9)
    assert abs(na - nb) / max(nb, 1) <= 1e-3, (na, nb)
    assert mean_rel <= 1e-3, (a.mean(), b.mean())
    assert frac_off <= 0.02, frac_off


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small tensors run as fast on one, and
    the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("w,spp,rr,sb", [(16, 2, 3, 1), (24, 4, 4, 2)])
def test_render_image_matches_reference(w, spp, rr, sb):
    js, jc, ts, tc = _pair(w)
    ji, jn = jb.render_image(js, jc, jb.BDPTConfig(w, w, spp=spp,
                                                   rr_depth=rr), seed=1,
                             samples_per_batch=sb)
    ti, tn = tb.render_image(ts, tc, tb.BDPTConfig(w, w, spp=spp,
                                                   rr_depth=rr), seed=1,
                             samples_per_batch=sb)
    ti = ti.numpy()
    assert ti.shape == (w, w, 3) and np.isfinite(ti).all()
    assert tn > w * w * spp
    _gate(ti, np.asarray(ji), tn, jn)


def _primaries(w=16, scene=GLASS, **cfg):
    """Both packages' scenes, camera constants, configs, lane keys and
    primary rays (direction, alive) of one sample at seed 5: (js, jcc,
    cfg_j, jk, jd, jalive, ts, tcc, cfg_t, tk, td, talive)."""
    js, jc, ts, tc = _pair(w, scene)
    cfg = {"spp": 2, "rr_depth": 4, **cfg}
    cfg_j = jb.BDPTConfig(w, w, **cfg)
    cfg_t = tb.BDPTConfig(w, w, **cfg)
    pix = np.arange(w * w, dtype=np.int32)
    jk = jrng.lane_keys(jax.random.key(5), jnp.asarray(pix))
    tk = trng.lane_keys(trng.key(5, device="cpu"), torch.from_numpy(pix))
    jcc = jc.device_constants()
    tcc = tc.device_constants("cpu")
    jitter = jrng.uniform2(jrng.lane_fold(jk, jrng.PIXEL_JITTER))
    _, jd = jcam.generate_rays(jcc, w, w, jnp.asarray(pix), jitter)
    alive = np.array(jax_trace_closest(
        js, jnp.broadcast_to(jcc["o"], jd.shape), jd, 1.0, 1000.0).valid)
    return (js, jcc, cfg_j, jk, jd, jnp.asarray(alive), ts, tcc, cfg_t, tk,
            torch.from_numpy(np.array(jd)), torch.from_numpy(alive))


def _walks(w=16, scene=GLASS, **cfg):
    """Both packages' fused_subpath_walks at the same lane keys and
    primary rays; returns (js, jcc, cfg_j, jout, ts, tcc, cfg_t, tout)."""
    (js, jcc, cfg_j, jk, jd, ja, ts, tcc, cfg_t, tk, td,
     ta) = _primaries(w, scene, **cfg)
    b = w * w
    jout = jb.fused_subpath_walks(js, jcc, cfg_j, jk, b, jd, ja)
    tout = tb.fused_subpath_walks(ts, tcc, cfg_t, tk, b, td, ta)
    return js, jcc, cfg_j, jout, ts, tcc, cfg_t, tout


def _assert_slots_match(t_slots, j_slots):
    """Subpath slots of both packages: flags and triangle ids exactly,
    the rest to rtol 1e-4 / atol 1e-5."""
    np.testing.assert_array_equal(t_slots.valid.numpy(),
                                  np.asarray(j_slots.valid))
    np.testing.assert_array_equal(t_slots.tri.numpy(),
                                  np.asarray(j_slots.tri))
    for name in ("p", "ns", "wo", "throughput", "vcm", "vc", "rr", "u",
                 "v"):
        np.testing.assert_allclose(
            getattr(t_slots, name).numpy(),
            np.asarray(getattr(j_slots, name)), rtol=1e-4, atol=1e-5,
            err_msg=name)


def _assert_walks_match(jout, tout):
    """Every output of both packages' fused_subpath_walks."""
    (jl, jpix, jrgb, jok, jli, je, jnee, jn) = jout
    (tl, tpix, trgb, tok, tli, te, tnee, tn) = tout
    assert int(tn) == int(jn)
    _assert_slots_match(tl, jl)
    _assert_slots_match(te, je)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tpix.numpy(), np.asarray(jpix))
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tli.numpy(), np.asarray(jli), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(tnee[1].numpy(), np.asarray(jnee[1]))
    for i in (0, 2):
        np.testing.assert_allclose(tnee[i].numpy(), np.asarray(jnee[i]),
                                   rtol=1e-4, atol=1e-5)


def test_fused_subpath_walks_match_reference():
    """One fused_subpath_walks call at the same lane keys and primary
    rays: every per-depth output of both walks."""
    _, _, _, jout, _, _, _, tout = _walks()
    _assert_walks_match(jout, tout)


def test_samples_per_batch_does_not_change_the_estimate():
    _, _, ts, tc = _pair(16)
    cfg = tb.BDPTConfig(16, 16, spp=4, rr_depth=3)
    a, na = tb.render_image(ts, tc, cfg, seed=3, samples_per_batch=1)
    b, nb = tb.render_image(ts, tc, cfg, seed=3, samples_per_batch=4)
    assert na == nb
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


_ONCE_RAISED = [dict(mode="path_trace"), dict(mode="light_trace"),
                dict(no_rr=False, max_bounces=4), dict(rr_depth=1),
                dict(rr_depth=4), dict(rr_depth=1, mode="light_trace")]


@pytest.mark.parametrize("change", _ONCE_RAISED,
                         ids=["path_trace", "light_trace", "rr", "no_steps",
                              "chunked", "no_steps_light_trace"])
def test_configs_once_outside_the_slice_render(change, monkeypatch):
    """The configurations the port once refused render as the reference
    renders them.  Without a walk step (rr_depth 1) render_sample takes
    its non-mega branch: BDPT traces the primaries alone and gives a black
    image, the light tracer adds the emitter the primary ray sees; both
    exactly as the reference."""
    js, jc, ts, tc = _pair(16)
    # chunked: a 3 x 3 x 512-lane pair grid against a budget of 1,000
    # lanes, so the pairs go in three one-row chunks.
    monkeypatch.setattr(jb, "_MEGA_MAX_LANES", 1000)
    monkeypatch.setattr(tb, "MEGA_MAX_LANES", 1000)
    cfg = {"spp": 2, "rr_depth": 3, **change}
    ji, jn = jb.render_image(js, jc, jb.BDPTConfig(16, 16, **cfg), seed=1,
                             samples_per_batch=2)
    ti, tn = tb.render_image(ts, tc, tb.BDPTConfig(16, 16, **cfg), seed=1,
                             samples_per_batch=2)
    ti, ji = ti.numpy(), np.asarray(ji)
    assert np.isfinite(ti).all() and (ti >= 0).all()
    if cfg["rr_depth"] == 1:
        assert tn == jn == 16 * 16 * 2
        np.testing.assert_array_equal(ti, ji)
        assert (ji.max() > 0.0) == (cfg.get("mode") == "light_trace")
    else:
        assert ti.mean() > 0.0
        _gate(ti, ji, tn, jn)


def test_render_sample_derives_lane_keys_from_the_key():
    """render_sample(..., key, pixel_idx) with lkeys=None keys its lanes
    by rng.lane_keys(key, pixel_idx), as the reference does."""
    _, _, ts, tc = _pair(16)
    cfg = tb.BDPTConfig(16, 16, spp=2, rr_depth=3)
    cc = tc.device_constants("cpu")
    key = trng.key(11, device="cpu")
    pix = torch.arange(256, dtype=torch.int32)
    a, na = tb.render_sample(ts, cc, cfg, key, pix)
    b, nb = tb.render_sample(ts, cc, cfg, key, pix,
                             lkeys=trng.lane_keys(key, pix))
    assert int(na) == int(nb) > 256
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(a.sum()) > 0.0


def test_render_chunk_refuses_a_key_on_another_device():
    _, _, ts, tc = _pair(16)
    cfg = tb.BDPTConfig(16, 16, spp=1, rr_depth=3)
    key = trng.key(0, device="meta")
    with pytest.raises(ValueError, match="device|meta"):
        tb.render_chunk(ts, tc.device_constants("cpu"), cfg, key)


def test_mega_connect_matches_reference():
    """`_mega_connect` of both packages on the reference's walk outputs:
    the one any-hit trace over NEE, t=1 and pair segments, and the
    MIS-weighted sums."""
    js, jcc, cfg_j, jout, ts, tcc, cfg_t, _ = _walks()
    (jl, jpix, jrgb, jok, _, je, (jnee_li, jnee_ok, jnee_end), _) = jout

    def t(a):
        return torch.from_numpy(np.array(a))

    jr = jb._mega_connect(js, jcc, cfg_j, je, jl, jnee_li, jnee_ok,
                          jnee_end, jpix, jrgb, jok)
    tr = tb._mega_connect(
        ts, tcc, cfg_t, tb.LightVertexSlots(*(t(a) for a in je)),
        tb.LightVertexSlots(*(t(a) for a in jl)), t(jnee_li), t(jnee_ok),
        t(jnee_end), t(jpix), t(jrgb), t(jok))
    (jli, jspix, jsrgb, jn), (tli, tspix, tsrgb, tn) = jr, tr
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tspix.numpy(), np.asarray(jspix))
    np.testing.assert_allclose(tsrgb.numpy(), np.asarray(jsrgb), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tli.numpy(), np.asarray(jli), rtol=1e-4,
                               atol=1e-6)
    assert float(tli.sum()) > 0.0
