"""The port's BDPT against its own other estimators, as tests/test_bdpt.py
holds the reference package's: on the all-diffuse Cornell box, BDPT, the
path tracer and the light tracer agree within Monte-Carlo noise
(variance-aware z-tests over replicate renders at disjoint seeds); a 3%
bias injected into one technique trips the gate; renders are
deterministic in the seed.  The port alone, on the CPU through its plain
trace versions.

Which estimators estimate the same image: with Russian roulette to
RR_BOUNCES bounces all three do (up to paths longer than that).  Without
it (rr_depth 3, two walk steps) the path and light tracers see the same
paths (one or two surface vertices), but BDPT also connects two-step eye
and light walks (up to four vertices) and, at two vertices, lacks the
s=0 technique (an emitter hit one step past the walk) that its MIS
weights count: a truncation of its own, 1.4-1.7% above the others at
64x64 on an H100 (PERF.md), which these 16x16 renders cannot resolve.
On deep walks (DEEP_RR_DEPTH) those paths carry too little light to
show, and BDPT is held to the others without roulette too.

The glass box is not used here: light tracing cannot reach a path whose
first eye vertex is a delta BSDF (no t=1 splat from a delta vertex), so
there the light tracer is low by design."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bpt_tpu_torch.integrators import mis as mis_mod
from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_image
from bpt_tpu_torch.scene.procedural import cornell_box_scene

W = H = 16
R = 4          # independent replicates per mode (variance estimation)
SPP_REP = 8    # spp per replicate
Z_GATE = 4.0   # |z| >= 4 has p < 1e-4 under the null (agreement)
RR_BOUNCES = 8
RR = dict(no_rr=False, rr_depth=3, max_bounces=RR_BOUNCES)
DEEP_RR_DEPTH = 12   # no roulette, 11 walk steps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small tensors run as fast on one, and
    the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def box():
    return cornell_box_scene(W, H, device="cpu")


def _replicates(scene, cam, cfg):
    """R renders at seeds 100..100+R-1, one batch of SPP_REP samples."""
    out = []
    for r in range(R):
        img, nrays = render_image(scene, cam, cfg, seed=100 + r,
                                  spp_chunk=SPP_REP,
                                  samples_per_batch=SPP_REP)
        assert nrays > 0
        out.append(img.numpy())
    return np.stack(out)  # (R, H, W, 3)


def _mode_renders(box, **cfg):
    scene, _, cam = box
    return {mode: _replicates(scene, cam, BDPTConfig(W, H, spp=SPP_REP,
                                                     mode=mode, **cfg))
            for mode in ("bdpt", "path_trace", "light_trace")}


@pytest.fixture(scope="module")
def renders(box):
    """The three estimators with Russian roulette."""
    return _mode_renders(box, **RR)


@pytest.fixture(scope="module")
def renders_no_rr(box):
    """The three estimators with two walk steps and no roulette."""
    return _mode_renders(box, rr_depth=3)


@pytest.fixture(scope="module")
def renders_no_rr_deep(box):
    """The three estimators with 11 walk steps and no roulette."""
    return _mode_renders(box, rr_depth=DEEP_RR_DEPTH)


def _mean_se(imgs):
    """Mean of replicate image-means and its standard error."""
    m = imgs.mean(axis=(1, 2, 3))
    return float(m.mean()), float(m.std(ddof=1) / np.sqrt(len(m)))


def _z(a, b):
    ma, sa = _mean_se(a)
    mb, sb = _mean_se(b)
    return abs(ma - mb) / np.sqrt(sa * sa + sb * sb + 1e-30)


def test_all_modes_finite_nonnegative(renders, renders_no_rr):
    for imgs_by_mode in (renders, renders_no_rr):
        for mode, imgs in imgs_by_mode.items():
            assert np.isfinite(imgs).all(), mode
            assert (imgs >= 0).all(), mode
            assert imgs.mean() > 0.1, mode


@pytest.mark.parametrize("other", ["path_trace", "light_trace"])
def test_bdpt_matches_other_estimator(renders, other):
    z = _z(renders["bdpt"], renders[other])
    assert z < Z_GATE, f"z={z:.2f}"


@pytest.mark.parametrize("other", ["path_trace", "light_trace"])
def test_bdpt_matches_other_estimator_without_rr_on_deep_walks(
        renders_no_rr_deep, other):
    """Without roulette the estimators part only by truncation, which
    deep walks no longer show."""
    z = _z(renders_no_rr_deep["bdpt"], renders_no_rr_deep[other])
    assert z < Z_GATE, f"z={z:.2f}"


def test_path_tracer_matches_light_tracer_without_rr(renders_no_rr):
    z = _z(renders_no_rr["path_trace"], renders_no_rr["light_trace"])
    assert z < Z_GATE, f"z={z:.2f}"


def test_blockwise_agreement(renders):
    """4x4 block means of BDPT vs the path tracer: per-block t_3
    statistics from the replicate spread; the bulk must agree."""
    def blocks(imgs):  # (R, H, W, 3) -> (R, nby, nbx)
        b = imgs.reshape(R, H // 4, 4, W // 4, 4, 3).mean(axis=(2, 4))
        return b @ np.array([0.2126, 0.7152, 0.0722])

    b1, b2 = blocks(renders["bdpt"]), blocks(renders["path_trace"])
    se1 = b1.std(0, ddof=1) / np.sqrt(R)
    se2 = b2.std(0, ddof=1) / np.sqrt(R)
    z = np.abs(b1.mean(0) - b2.mean(0)) / np.sqrt(se1 ** 2 + se2 ** 2
                                                  + 1e-12)
    assert np.quantile(z, 0.9) < 8.0, np.quantile(z, 0.9)
    assert np.median(z) < 3.0, np.median(z)


def test_injected_technique_bias_fails_gate(box, renders, monkeypatch):
    """A 3% bias on the s=1 (NEE) MIS weight must trip the z-gate; the
    seeds are paired with the clean renders, so the MC noise cancels."""
    scene, _, cam = box
    orig = mis_mod.weight_s1
    monkeypatch.setattr(mis_mod, "weight_s1",
                        lambda *a, **k: 1.03 * orig(*a, **k))
    biased = _replicates(scene, cam, BDPTConfig(W, H, spp=SPP_REP, **RR))
    d = (biased - renders["bdpt"]).mean(axis=(1, 2, 3))
    z = abs(d.mean()) / (d.std(ddof=1) / np.sqrt(R) + 1e-30)
    assert z > Z_GATE, f"bias not detected: z={z:.2f}"


def test_deterministic(box):
    scene, _, cam = box
    cfg = BDPTConfig(W, H, spp=4, rr_depth=2)
    img1, n1 = render_image(scene, cam, cfg, seed=9)
    img2, n2 = render_image(scene, cam, cfg, seed=9)
    assert n1 == n2
    np.testing.assert_array_equal(img1.numpy(), img2.numpy())


def test_seed_changes_noise(box):
    scene, _, cam = box
    cfg = BDPTConfig(W, H, spp=2, rr_depth=2)
    img1, _ = render_image(scene, cam, cfg, seed=1)
    img2, _ = render_image(scene, cam, cfg, seed=2)
    assert not np.array_equal(img1.numpy(), img2.numpy())


@pytest.mark.parametrize("mode", ["bdpt", "path_trace"])
def test_rr_mode_is_not_darker(renders, renders_no_rr, mode):
    """Russian roulette to 8 bounces adds the longer paths: its estimate
    is not darker than the 2-bounce NO_RR one at the same seeds (the
    same pixel jitter, so the emitter's own pixels cancel)."""
    rr, no_rr = renders[mode].mean(), renders_no_rr[mode].mean()
    assert rr > 0.1 and rr > 0.98 * no_rr, (rr, no_rr)
