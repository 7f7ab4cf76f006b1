"""BSDFs, MIS recursion and interaction/emitter helpers of the port
against the reference package (rtol 1e-5: f32 transcendentals -- pow,
sqrt, cos -- round differently in XLA and PyTorch).

Two measured exceptions get an absolute tolerance: the cosine-hemisphere
lift z = sqrt(1 - r^2) turns one ulp of cos/sin into ~1.8e-6 near the
rim (sampled directions: LIFT_ATOL), and XLA:CPU flushes f32 subnormals
to zero where PyTorch keeps them (MIS weights 1/(1 + FLT_MAX) =
2.9e-39: SUBNORMAL_ATOL)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.bsdf import bsdf as jb
from bpt_tpu.core import rng as jrng
from bpt_tpu.integrators import common as jcommon
from bpt_tpu.integrators import mis as jmis
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.accel.api import Hit as THit
from bpt_tpu_torch.bsdf import bsdf as tb
from bpt_tpu_torch.core import rng as trng
from bpt_tpu_torch.integrators import common as tcommon
from bpt_tpu_torch.integrators import mis as tmis
from bpt_tpu_torch.ops.trace_closest import closest_hit_plain
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays

N = 4096
RTOL, ATOL = 1e-5, 1e-6
LIFT_ATOL = 5e-6
SUBNORMAL_ATOL = 1.2e-38  # below the smallest normal f32

# kind, Kd, Ks, Ns, Ni, Tf
_MATS = [
    (jb.DIFFUSE, [0.7, 0.6, 0.5], [0, 0, 0], 1.0, 1.0, [0, 0, 0]),
    (jb.MIRROR, [0, 0, 0], [1, 1, 1], 1.0, 1.0, [0, 0, 0]),
    (jb.GLASS, [1, 1, 1], [1, 1, 1], 30.0, 1.5, [0.9, 0.95, 1.0]),
    (jb.PHONG, [0.5, 0.4, 0.3], [0.4, 0.5, 0.6], 20.0, 1.0, [0, 0, 0]),
    (jb.MIXTURE, [0.3, 0.3, 0.3], [0.6, 0.5, 0.4], 40.0, 1.0, [0, 0, 0]),
]
KIND_IDS = ["diffuse", "mirror", "glass", "phong", "mixture"]


def _tables():
    arr = dict(
        kind=np.array([m[0] for m in _MATS], np.int32),
        diffuse=np.array([m[1] for m in _MATS], np.float32),
        specular=np.array([m[2] for m in _MATS], np.float32),
        emission=np.zeros((len(_MATS), 3), np.float32),
        shininess=np.array([m[3] for m in _MATS], np.float32),
        ior=np.array([m[4] for m in _MATS], np.float32),
        transmittance=np.array([m[5] for m in _MATS], np.float32),
    )
    jt = jb.MaterialTable(**{k: jnp.asarray(v) for k, v in arr.items()})
    tt = tb.MaterialTable(**{k: torch.from_numpy(v) for k, v in arr.items()})
    return jt, tt


def _dirs(seed, n=N, upper=None):
    d = np.random.RandomState(seed).normal(size=(n, 3)).astype(np.float32)
    if upper is not None:
        d[:, 2] = np.abs(d[:, 2]) * (1 if upper else -1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _close(j, t, rtol=RTOL, atol=ATOL):
    if isinstance(t, torch.Tensor) and t.dtype == torch.bool:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                                   atol=atol)


def _lanes(kind_idx, n=N):
    jt, tt = _tables()
    mid = np.full(n, kind_idx, np.int32)
    return (jb.gather_lane(jt, jnp.asarray(mid)),
            tb.gather_lane(tt, torch.from_numpy(mid)))


@pytest.mark.parametrize("k", range(5), ids=KIND_IDS)
def test_gather_lane(k):
    jl, tl = _lanes(k)
    for name in jl._fields:
        _close(getattr(jl, name), getattr(tl, name))


@pytest.mark.parametrize("k", range(5), ids=KIND_IDS)
def test_eval_pdfs_and_pdf_lane(k):
    jl, tl = _lanes(k)
    wo, wi = _dirs(1), _dirs(2)
    jf = jb.eval_pdfs_lane(jl, jnp.asarray(wo), jnp.asarray(wi))
    tf = tb.eval_pdfs_lane(tl, torch.from_numpy(wo), torch.from_numpy(wi))
    for j, t in zip(jf, tf):
        _close(j, t)
    _close(jb.pdf_lane(jl, jnp.asarray(wo), jnp.asarray(wi)),
           tb.pdf_lane(tl, torch.from_numpy(wo), torch.from_numpy(wi)))
    # The fused form equals the separate reference calls.
    _close(jb.eval_lane(jl, jnp.asarray(wo), jnp.asarray(wi)), tf[0])
    _close(jb.pdf_lane(jl, jnp.asarray(wi), jnp.asarray(wo)), tf[2])


@pytest.mark.parametrize("k", range(5), ids=KIND_IDS)
@pytest.mark.parametrize("side", ["outside", "inside"])
def test_sample_lane(k, side):
    """Both hemispheres: for glass 'inside' includes total internal
    reflection (grazing exits with sin > 1/1.5)."""
    jl, tl = _lanes(k)
    wo = _dirs(3, upper=side == "outside")
    u2 = np.random.RandomState(4).rand(N, 2).astype(np.float32)
    js = jb.sample_lane(jl, jnp.asarray(wo), jnp.asarray(u2))
    ts = tb.sample_lane(tl, torch.from_numpy(wo), torch.from_numpy(u2))
    for name in js._fields:
        _close(getattr(js, name), getattr(ts, name), atol=LIFT_ATOL)
    if k == 2 and side == "inside":
        tir = (1.5 ** 2) * (1.0 - wo[:, 2] ** 2) >= 1.0
        assert tir.sum() > 100
        wi = ts.wi.numpy()
        # TIR reflects: same hemisphere as wo.
        assert np.all(wi[tir, 2] < 0)


@pytest.mark.parametrize("name", [
    "light_walk_init", "eye_walk_init", "measure_update", "bounce_update",
    "weight_s0", "weight_s1", "weight_connect", "weight_t1"])
def test_mis_functions(name):
    rs = np.random.RandomState(5)

    def pos(n=N):
        x = np.exp(rs.uniform(-6, 6, n)).astype(np.float32)
        x[:3] = [0.0, np.inf, 1e-30]  # 0 * inf / overflow corners
        return x

    jf, tf = getattr(jmis, name), getattr(tmis, name)
    if name == "eye_walk_init":
        args = [np.float32(4096.0), pos()]
    elif name == "bounce_update":
        args = [pos(), pos(), pos(), pos(), pos(), rs.rand(N) < 0.3]
    else:
        n_args = {"light_walk_init": 3, "measure_update": 4,
                  "weight_s0": 4, "weight_s1": 6, "weight_connect": 8,
                  "weight_t1": 5}[name]
        args = [pos() for _ in range(n_args)]
        if name == "weight_t1":
            args[1] = np.float32(4096.0)
    jout = jf(*[jnp.asarray(a) for a in args])
    tout = tf(*[torch.from_numpy(np.asarray(a)) if np.ndim(a) else float(a)
                for a in args])
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=SUBNORMAL_ATOL)


@pytest.fixture(scope="module")
def scenes():
    js, _, _ = jax_cbox(32, 32, right_object="glass_sphere", sphere_subdiv=3)
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    return js, ts


def test_make_interaction(scenes):
    js, ts = scenes
    rs = np.random.RandomState(6)
    n = 2048
    o = rs.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(
        np.float32)
    d = _dirs(7, n)
    t, tri, u, v = closest_hit_plain(
        ts.treelets, torch.from_numpy(o), torch.from_numpy(d),
        torch.full((n,), 1e-8), torch.full((n,), float("inf")))
    th = THit(t=t, tri=tri, u=u, v=v, valid=tri >= 0)
    jh = jcommon.Hit(t=jnp.asarray(t.numpy()), tri=jnp.asarray(tri.numpy()),
                     u=jnp.asarray(u.numpy()), v=jnp.asarray(v.numpy()),
                     valid=jnp.asarray((tri >= 0).numpy()))
    ji = jcommon.make_interaction(js, jnp.asarray(d), jh)
    ti = tcommon.make_interaction(ts, torch.from_numpy(d), th)
    for name in ji._fields:
        _close(getattr(ji, name), getattr(ti, name))


def test_sample_emitter_position(scenes):
    js, ts = scenes
    ids = np.arange(N, dtype=np.int32)
    jk = jrng.lane_fold(jrng.lane_keys(jax.random.key(3), jnp.asarray(ids)),
                        jrng.NEE_WALK)
    tk = trng.lane_fold(trng.lane_keys(trng.key(3, device="cpu"),
                                       torch.from_numpy(ids)),
                        trng.NEE_WALK)
    je = jcommon.sample_emitter_position(js, jk)
    te = tcommon.sample_emitter_position(ts, tk)
    for name in je._fields:
        _close(getattr(je, name), getattr(te, name))
    _close(jcommon.emission_at(js, jnp.asarray(ids % 8)),
           tcommon.emission_at(ts, torch.from_numpy(ids % 8)))
