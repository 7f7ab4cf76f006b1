"""The pooled estimator's mean depends on the pool size, in the reference
package as in the port.

On the all-diffuse Cornell box at 16x16 (rr_depth 3), the reference's
`render_sample_pool` is run with a pool of 16 light subpaths and with a
pool of W*H, on the same keys: the same eye paths, the first 16 pool
paths alike.  Each of SEEDS gives one image mean over SPP samples a pool
size; the paired differences carry little of the noise, so a gap of a
few percent stands far outside their standard error.  At a pool of W*H
the MIS weights are the per-pixel ones, and the mean agrees with the
reference's per-pixel `render_image`.  The gap goes with the MIS
weights' light-path count, not with the pool: a pool of 16 whose weights
count W*H paths gives the mean of the pool of W*H.  The port gives the
reference's sample at both pool sizes, so the gap it shows on the card is
the reference's estimator, not a fault of the port."""
from __future__ import annotations

from contextlib import nullcontext
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.integrators import bdpt as jb
from bpt_tpu.integrators import mis as jmis
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.core import camera as tcam
from bpt_tpu_torch.core import rng as trng
from bpt_tpu_torch.integrators import bdpt as tb
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays

W = 16
SMALL_POOL = 16
POOLS = (SMALL_POOL, W * W)
# (pool size, light-path count of the MIS weights): the pool of 16 also
# with the weights of the pool of W*H.
RUNS = ((SMALL_POOL, SMALL_POOL), (W * W, W * W), (SMALL_POOL, W * W))
SEEDS = range(200, 208)
SPP = 16
RR = 3


def _gate(a, b, na, nb):
    """tests/test_torch_bdpt.py's aggregate gate: nrays within 1e-3,
    image mean within 1e-3 relative, at most 2% of the pixels off by more
    than 0.1%."""
    denom = np.maximum(np.abs(b), 1e-3)
    frac_off = float((np.abs(a - b) / denom > 1e-3).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(
        float(b.mean()), 1e-9)
    assert abs(na - nb) / max(nb, 1) <= 1e-3, (na, nb)
    assert mean_rel <= 1e-3, (a.mean(), b.mean())
    assert frac_off <= 0.02, frac_off


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mis_count(n):
    """The reference's MIS functions with their light-path count set to
    n (the eye walk's initial vcm and the t=1 weight); the t=1 splats
    keep the pool's 1/N."""
    init, t1 = jmis.eye_walk_init, jmis.weight_t1
    return mock.patch.multiple(
        jmis, eye_walk_init=lambda _, t1_pdf: init(float(n), t1_pdf),
        weight_t1=lambda a, _, p, vc, vcm: t1(a, float(n), p, vc, vcm))


@pytest.fixture(scope="module")
def ref():
    """The reference's image means: pooled for each of RUNS on the keys
    of SEEDS, per-pixel on other seeds; and the first sample of the first
    seed at each pool size, with its ray count."""
    js, _, jc = jax_cbox(W, W)
    jcc = jc.device_constants()
    pix = jnp.arange(W * W, dtype=jnp.int32)
    means, first = {}, {}
    for pool, count in RUNS:
        cfg = jb.BDPTConfig(W, W, spp=SPP, rr_depth=RR, light_pool=pool)
        pids = jnp.arange(pool, dtype=jnp.int32)

        def sample(key, s, cfg=cfg, pids=pids):
            return jb.render_sample_pool(js, jcc, cfg,
                                         jax.random.fold_in(key, s), pix,
                                         pids)

        @jax.jit
        def run(key, sample=sample):
            fb0, nr0 = sample(key, 0)
            total = jax.lax.fori_loop(
                1, SPP, lambda s, acc: acc + jnp.mean(sample(key, s)[0]),
                jnp.mean(fb0))
            return total, fb0, nr0

        # jit traces at the first call, inside the patch.
        with nullcontext() if count == pool else _mis_count(count):
            got = [run(jax.random.key(seed)) for seed in SEEDS]
        means[pool, count] = np.array([float(g[0]) for g in got])
        if count == pool:
            first[pool] = (np.asarray(got[0][1]), int(got[0][2]))
    cfg = jb.BDPTConfig(W, W, spp=SPP, rr_depth=RR)
    per_pixel = np.array([
        float(jnp.mean(jb.render_image(js, jc, cfg, seed=300 + i,
                                       spp_chunk=SPP)[0]))
        for i in range(len(SEEDS))])
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    tc = tcam.Camera.make(jc.o, jc.at, jc.up, jc.fov, jc.width, jc.height)
    return dict(means=means, first=first, per_pixel=per_pixel, ts=ts, tc=tc)


def _se(x):
    return float(np.std(x, ddof=1) / np.sqrt(len(x)))


def test_reference_pooled_mean_moves_with_the_pool_size(ref):
    """A pool of 16 stands more than 1% above a pool of W*H on the same
    keys, |z| > 4 on the paired differences."""
    small = ref["means"][SMALL_POOL, SMALL_POOL]
    full = ref["means"][W * W, W * W]
    d = small - full
    gap = small.mean() / full.mean() - 1
    z = d.mean() / _se(d)
    assert gap > 0.01 and z > 4.0, (gap, z)


def test_reference_pool_of_w_h_agrees_with_per_pixel(ref):
    """At a pool of W*H the reference's pooled and per-pixel means agree
    within 4 standard errors."""
    full, pp = ref["means"][W * W, W * W], ref["per_pixel"]
    se = np.hypot(_se(full), _se(pp))
    assert abs(full.mean() - pp.mean()) < 4.0 * se, (full.mean(),
                                                      pp.mean(), se)


def test_reference_gap_goes_with_the_mis_count(ref):
    """The pool of 16 with the weights' light-path count set to W*H: on
    the same keys its mean is the pool of W*H's (within 0.5%, |z| < 4),
    so the gap comes from the count in the weights, not from the smaller
    pool's estimate."""
    got = ref["means"][SMALL_POOL, W * W]
    full = ref["means"][W * W, W * W]
    d = got - full
    gap = got.mean() / full.mean() - 1
    assert abs(gap) < 0.005 and abs(d.mean() / _se(d)) < 4.0, (gap, d)


@pytest.mark.parametrize("pool", POOLS)
def test_port_sample_is_the_reference_sample(ref, pool):
    """The port's render_sample_pool on the first key of SEEDS, at each
    pool size, against the reference's."""
    cfg = tb.BDPTConfig(W, W, spp=SPP, rr_depth=RR, light_pool=pool)
    key = trng.fold_in(trng.key(SEEDS[0], device="cpu"), 0)
    fb, nrays = tb.render_sample_pool(
        ref["ts"], ref["tc"].device_constants("cpu"), cfg, key,
        torch.arange(W * W, dtype=torch.int32),
        torch.arange(pool, dtype=torch.int32))
    j_fb, j_nrays = ref["first"][pool]
    _gate(fb.numpy(), j_fb, int(nrays), j_nrays)
