"""The port's differentiable rendering (diff/grad.py, diff/inverse.py)
against the reference package on the CPU, from the same scene arrays and
seed: loss and gradients of every material field in bdpt, path_trace,
light_trace and Russian-roulette mode (loss rtol 1e-5; each field's
gradient within 1e-4 of the reference's largest |g| of that field, plus
1e-7), the reference's own five gradient checks (tests/test_grad.py) on
the port, the emitter radiance rebound by apply_params, recover_materials
following the reference's iterates (rtol 1e-4), and a guard that no
tensor handed to a tracer requires grad (traversal and the trace kernels
stay outside the autograd graph)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.diff import grad as jg
from bpt_tpu.diff import inverse as jinv
from bpt_tpu.integrators.bdpt import BDPTConfig as JConfig
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.core import camera as tcam
from bpt_tpu_torch.core import rng as trng
from bpt_tpu_torch.diff import grad as tg
from bpt_tpu_torch.diff import inverse as tinv
from bpt_tpu_torch.integrators import bdpt as tb
from bpt_tpu_torch.integrators import common as tcommon
from bpt_tpu_torch.scene.procedural import cornell_box_scene
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays
from test_torch_bdpt import _one_thread  # noqa: F401  (a fixture)

W = H = 16
SEED = 11
SPP_CHUNK = 2
# tests/test_grad.py's configuration, and its modes with Russian roulette.
BASE = dict(spp=4, rr_depth=3)
MODES = {
    "bdpt": {},
    "path_trace": dict(mode="path_trace"),
    "light_trace": dict(mode="light_trace"),
    "rr": dict(no_rr=False, rr_depth=2, max_bounces=6),
}


def _both(w, h=None):
    """The reference's glass box (sphere_subdiv 1) and the port's scene
    built from its arrays, with both packages' camera constants:
    (js, jc, jcc, ts, tc, tcc)."""
    js, _, jc = jax_cbox(w, h or w, right_object="glass_sphere",
                         sphere_subdiv=1)
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    tc = tcam.Camera.make(jc.o, jc.at, jc.up, jc.fov, jc.width, jc.height)
    return js, jc, jc.device_constants(), ts, tc, tc.device_constants("cpu")


@pytest.fixture(scope="module")
def pair():
    return _both(W, H)


@pytest.fixture(scope="module")
def reference(pair):
    """The reference's loss_and_grad in every mode, each computed once:
    {mode: (loss, {field: gradient})}."""
    js, _, jcc, _, _, _ = pair
    params = jg.extract_params(js)
    target = jnp.zeros((W * H, 3), jnp.float32)
    out = {}
    for mode, change in MODES.items():
        loss, g = jg.loss_and_grad(params, js, jcc,
                                   JConfig(W, H, **{**BASE, **change}),
                                   jax.random.key(SEED), SPP_CHUNK, target)
        out[mode] = float(loss), {k: np.asarray(v) for k, v in g.items()}
    return out


def _port_loss_and_grad(pair, mode):
    _, _, _, ts, _, tcc = pair
    return tg.loss_and_grad(tg.extract_params(ts), ts, tcc,
                            tb.BDPTConfig(W, H, **{**BASE, **MODES[mode]}),
                            trng.key(SEED, "cpu"), SPP_CHUNK,
                            torch.zeros((W * H, 3)))


@pytest.mark.parametrize("mode", list(MODES))
def test_loss_and_grad_matches_reference(pair, reference, mode):
    ref_loss, ref_g = reference[mode]
    loss, g = _port_loss_and_grad(pair, mode)
    assert loss.shape == () and not loss.requires_grad
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    assert set(g) == set(tg.PARAM_FIELDS) == set(ref_g)
    for field, ref in ref_g.items():
        got = g[field]
        assert got.shape == ref.shape and got.dtype == torch.float32
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale + 1e-7, err_msg=field)
    # The walls' albedo and the light's emission reach the loss in every
    # mode.
    assert float(g["diffuse"].abs().max()) > 0
    assert float(g["emission"].abs().max()) > 0


# ---- tests/test_grad.py's checks on the port ------------------------------

@pytest.fixture(scope="module")
def setup():
    """tests/test_grad.py's setup, built by the port."""
    scene, _, cam = cornell_box_scene(W, H, device="cpu",
                                      right_object="glass_sphere",
                                      sphere_subdiv=1)
    cc = cam.device_constants("cpu")
    cfg = tb.BDPTConfig(W, H, **BASE)
    params = tg.extract_params(scene)
    target = torch.zeros((W * H, 3), dtype=torch.float32)
    return scene, cc, cfg, trng.key(SEED, "cpu"), params, target


@pytest.fixture(scope="module")
def bdpt_grad(setup):
    scene, cc, cfg, key, params, target = setup
    return tg.loss_and_grad(params, scene, cc, cfg, key, SPP_CHUNK, target)


def test_gradients_finite_all_modes(setup):
    scene, cc, cfg, key, params, target = setup
    for mode in ("bdpt", "path_trace", "light_trace"):
        cfg_m = dataclasses.replace(cfg, mode=mode)
        loss, g = tg.loss_and_grad(params, scene, cc, cfg_m, key, SPP_CHUNK,
                                   target)
        assert np.isfinite(float(loss))
        for k, v in g.items():
            assert bool(torch.isfinite(v).all()), (mode, k)


def test_emission_gradient_nonzero(bdpt_grad):
    _, g = bdpt_grad
    assert float(torch.linalg.vector_norm(g["emission"])) > 0


@pytest.mark.parametrize("field,idx", [("diffuse", (0, 0)),
                                       ("emission", (5, 1))],
                         ids=["albedo_floor_red", "emission_light_green"])
def test_gradient_matches_finite_difference(setup, bdpt_grad, field, idx):
    """Central FD at common random numbers against autograd, on the
    floor's red albedo and the light's green emission."""
    scene, cc, cfg, key, params, target = setup
    _, g = bdpt_grad
    fd = tg.finite_difference_check(params, scene, cc, cfg, key, SPP_CHUNK,
                                    target, field, idx, eps=1e-2)
    ad = float(g[field][idx])
    assert np.isclose(float(fd), ad, rtol=0.05, atol=1e-4), (float(fd), ad)


def test_gradient_descent_reduces_loss(setup):
    """Three SGD steps on the parameters reduce an image-matching loss
    whose target is the scene with darker walls."""
    scene, cc, cfg, key, params, _ = setup
    dark = {**params, "diffuse": params["diffuse"] * 0.5}
    target_fb = tg.render_with_params(dark, scene, cc, cfg, key,
                                      SPP_CHUNK) * (cfg.spp / SPP_CHUNK)
    p = dict(params)
    losses = []
    for _ in range(3):
        loss, g = tg.loss_and_grad(p, scene, cc, cfg, key, SPP_CHUNK,
                                   target_fb)
        losses.append(float(loss))
        p = {k: v - 2.0 * g[k] for k, v in p.items()}
    assert losses[-1] < losses[0], losses


# ---- apply_params, recover_materials, the tracers' inputs ------------------

def test_apply_params_rebinds_emitter_radiance(pair):
    """apply_params sets emitters.radiance to emission[mat_id], as the
    reference does, so a gradient reaches the emission through NEE and
    the light walks."""
    js, _, _, ts, _, _ = pair
    rs = np.random.RandomState(3)
    emission = rs.uniform(0.0, 5.0, ts.mat.emission.shape).astype(np.float32)
    t_emission = torch.from_numpy(emission).requires_grad_(True)
    got = tg.apply_params(ts, {"emission": t_emission})
    ref = jg.apply_params(js, {"emission": jnp.asarray(emission)})
    np.testing.assert_array_equal(got.emitters.radiance.detach().numpy(),
                                  np.asarray(ref.emitters.radiance))
    assert got.emitters.radiance.requires_grad
    assert got.mat.emission is t_emission
    for f in ("diffuse", "specular", "transmittance"):
        assert getattr(got.mat, f) is getattr(ts.mat, f)
    np.testing.assert_array_equal(
        tg.apply_params(ts, tg.extract_params(ts)).emitters.radiance.numpy(),
        ts.emitters.radiance.numpy())


def test_recover_materials_matches_reference():
    """Three iterations at 8x8 from a perturbed start: the losses and the
    parameters follow the reference's within rtol 1e-4."""
    w = 8
    js, jc, jcc, ts, tc, tcc = _both(w)
    cfg = dict(spp=2, rr_depth=2)
    jp = jg.extract_params(js)
    j_target = jg.render_with_params(jp, js, jcc, JConfig(w, w, **cfg),
                                     jax.random.key(3), 2)
    t_target = tg.render_with_params(tg.extract_params(ts), ts, tcc,
                                     tb.BDPTConfig(w, w, **cfg),
                                     trng.key(3, "cpu"), 2)
    np.testing.assert_allclose(t_target.numpy(), np.asarray(j_target),
                               rtol=1e-5, atol=1e-6)
    init = {"diffuse": np.asarray(jp["diffuse"]) * 0.5 + 0.1,
            "emission": np.asarray(jp["emission"]) * 0.3}
    kw = dict(iterations=3, lr=0.2, spp_chunk=2, seed=7)
    ref = jinv.recover_materials(
        js, jc, JConfig(w, w, **cfg), j_target,
        init_params={k: jnp.asarray(v) for k, v in init.items()}, **kw)
    seen = []
    got = tinv.recover_materials(
        ts, tc, tb.BDPTConfig(w, w, **cfg), t_target,
        init_params={k: torch.from_numpy(v) for k, v in init.items()},
        callback=lambda it, loss, p: seen.append((it, loss)), **kw)
    assert got.iterations == 3 and len(got.losses) == 3
    assert [it for it, _ in seen] == [0, 1, 2]
    assert [loss for _, loss in seen] == got.losses
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    assert got.losses[-1] < got.losses[0]
    for f in tg.PARAM_FIELDS:
        np.testing.assert_allclose(got.params[f].numpy(),
                                   np.asarray(ref.params[f]), rtol=1e-4,
                                   atol=1e-7, err_msg=f)
    for f in ("specular", "transmittance"):   # not selected: frozen
        assert got.params[f] is getattr(ts.mat, f)


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _tensors(y)


@pytest.mark.parametrize("mode", list(MODES))
def test_no_tracer_input_requires_grad(pair, monkeypatch, mode):
    """Every call of a tracer during a differentiable render gets rays,
    bounds and trace tables that carry no gradient (a pybind kernel call
    would drop the graph silently), and no tracer output carries one."""
    calls = {}

    def guard(name, fn):
        def traced(scene, *args):
            tables = (scene.geom, scene.treelets, scene.treelets_any)
            for t in _tensors((tables, args)):
                assert not t.requires_grad, (name, mode)
            out = fn(scene, *args)
            assert not any(t.requires_grad for t in _tensors(out)), name
            calls[name] = calls.get(name, 0) + 1
            return out
        return traced

    for module in (tb, tcommon):
        for name in ("trace_closest", "trace_any"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name,
                                    guard(name, getattr(module, name)))
    loss, g = _port_loss_and_grad(pair, mode)
    assert calls.get("trace_closest", 0) > 0
    assert calls.get("trace_any", 0) > 0
    assert float(g["emission"].abs().max()) > 0


def _poison_rejected_weights(monkeypatch, mis, where, inf):
    """Make each MIS weight of connect, NEE and t=1 infinite on the lanes
    whose cosines reject them (a negative reverse area pdf), as a
    vanishing weight denominator makes it on a rejected lane."""
    def poisoned(fn, rejected):
        def weight(*args):
            return where(rejected(*args), inf, fn(*args))
        return weight

    monkeypatch.setattr(mis, "weight_connect", poisoned(
        mis.weight_connect, lambda lra, _a, _b, _c, era, *_: (lra < 0) |
        (era < 0)))
    monkeypatch.setattr(mis, "weight_s1", poisoned(
        mis.weight_s1, lambda _a, _b, eye_cur_rev_pdf_a, *_:
        eye_cur_rev_pdf_a < 0))
    monkeypatch.setattr(mis, "weight_t1", poisoned(
        mis.weight_t1, lambda image_to_surf, *_: image_to_surf < 0))


def test_rejected_lanes_give_no_nan_gradient(monkeypatch):
    """A lane that a connection rejects may carry a non-finite MIS
    weight (BASELINE config #5 met one at 1024x1024 after 17 steps).  The
    reference multiplies by the weight before it masks the lane, so its
    gradient turns NaN; the port zeroes the weight of a rejected lane
    first, so its gradient stays finite and equal to the gradient without
    the poisoned weights, and its loss is unchanged."""
    from bpt_tpu.integrators import mis as jmis
    from bpt_tpu_torch.integrators import mis as tmis

    w = 8
    js, _, jcc, ts, _, tcc = _both(w)
    cfg = dict(spp=4, rr_depth=3)
    t_args = (tg.extract_params(ts), ts, tcc, tb.BDPTConfig(w, w, **cfg),
              trng.key(5, "cpu"), 2, torch.zeros((w * w, 3)))
    loss0, g0 = tg.loss_and_grad(*t_args)

    _poison_rejected_weights(monkeypatch, jmis, jnp.where, jnp.inf)
    _poison_rejected_weights(monkeypatch, tmis, torch.where, float("inf"))
    _, jgrad = jg.loss_and_grad(
        jg.extract_params(js), js, jcc, JConfig(w, w, **cfg),
        jax.random.key(5), 2, jnp.zeros((w * w, 3), jnp.float32))
    assert any(np.isnan(np.asarray(v)).any() for v in jgrad.values())
    loss1, g1 = tg.loss_and_grad(*t_args)
    assert float(loss1) == float(loss0)
    for f in tg.PARAM_FIELDS:
        assert torch.isfinite(g1[f]).all(), f
        assert torch.equal(g1[f], g0[f]), f
