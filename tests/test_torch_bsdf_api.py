"""The table-level BSDF entry points the other integrators call
(`emission`, `eval_lane`, `eval_bsdf`, `pdf_bsdf`, `sample_bsdf`) against
the reference package, for the five kinds, with and without a textured
diffuse override.  Tolerances as tests/test_torch_shading.py (rtol 1e-5:
f32 transcendentals round differently in XLA and PyTorch; sampled
directions atol 5e-6 through the sqrt(1 - r^2) hemisphere lift)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.bsdf import bsdf as jb
from bpt_tpu_torch.bsdf import bsdf as tb

N = 4096
RTOL, ATOL = 1e-5, 1e-6
LIFT_ATOL = 5e-6

# kind, Kd, Ks, Ke, Ns, Ni, Tf
_MATS = [
    (jb.DIFFUSE, [0.7, 0.6, 0.5], [0, 0, 0], [0, 0, 0], 1.0, 1.0, [0, 0, 0]),
    (jb.MIRROR, [0, 0, 0], [1, 1, 1], [0, 0, 0], 1.0, 1.0, [0, 0, 0]),
    (jb.GLASS, [1, 1, 1], [1, 1, 1], [0, 0, 0], 30.0, 1.5, [0.9, 0.95, 1.0]),
    (jb.PHONG, [0.5, 0.4, 0.3], [0.4, 0.5, 0.6], [0, 0, 0], 20.0, 1.0,
     [0, 0, 0]),
    (jb.MIXTURE, [0.3, 0.3, 0.3], [0.6, 0.5, 0.4], [17.0, 12.0, 4.0], 40.0,
     1.0, [0, 0, 0]),
]
KIND_IDS = ["diffuse", "mirror", "glass", "phong", "mixture"]


def _tables():
    arr = dict(
        kind=np.array([m[0] for m in _MATS], np.int32),
        diffuse=np.array([m[1] for m in _MATS], np.float32),
        specular=np.array([m[2] for m in _MATS], np.float32),
        emission=np.array([m[3] for m in _MATS], np.float32),
        shininess=np.array([m[4] for m in _MATS], np.float32),
        ior=np.array([m[5] for m in _MATS], np.float32),
        transmittance=np.array([m[6] for m in _MATS], np.float32),
    )
    return (jb.MaterialTable(**{k: jnp.asarray(v) for k, v in arr.items()}),
            tb.MaterialTable(**{k: torch.from_numpy(v)
                                for k, v in arr.items()}))


def _dirs(seed, upper=None):
    d = np.random.RandomState(seed).normal(size=(N, 3)).astype(np.float32)
    if upper is not None:
        d[:, 2] = np.abs(d[:, 2]) * (1 if upper else -1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _inputs(k, textured):
    """(material ids, the diffuse override or None) of N lanes of kind k:
    the mixed-in lanes of every other kind keep the selects honest."""
    mid = np.full(N, k, np.int32)
    mid[::7] = np.arange(0, N, 7) % len(_MATS)
    kd = (np.random.RandomState(9).rand(N, 3).astype(np.float32)
          if textured else None)
    return mid, kd


def _close(t, j, atol=ATOL):
    if t.dtype == torch.bool:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=atol)


def _args(mid, kd, *vecs):
    j = [jnp.asarray(mid)] + [jnp.asarray(v) for v in vecs]
    t = [torch.from_numpy(mid)] + [torch.from_numpy(v) for v in vecs]
    return (j + [None if kd is None else jnp.asarray(kd)],
            t + [None if kd is None else torch.from_numpy(kd)])


@pytest.mark.parametrize("textured", [False, True], ids=["const", "tex"])
@pytest.mark.parametrize("k", range(5), ids=KIND_IDS)
def test_eval_and_pdf_bsdf(k, textured):
    jt, tt = _tables()
    mid, kd = _inputs(k, textured)
    ja, ta = _args(mid, kd, _dirs(1), _dirs(2))
    _close(tb.eval_bsdf(tt, *ta), jb.eval_bsdf(jt, *ja))
    _close(tb.pdf_bsdf(tt, *ta), jb.pdf_bsdf(jt, *ja))
    # The lane-level eval equals the fused eval of eval_pdfs_lane.
    lane = tb.gather_lane(tt, ta[0], ta[3])
    torch.testing.assert_close(tb.eval_lane(lane, ta[1], ta[2]),
                               tb.eval_pdfs_lane(lane, ta[1], ta[2])[0],
                               rtol=0, atol=0)


@pytest.mark.parametrize("side", ["outside", "inside"])
@pytest.mark.parametrize("k", range(5), ids=KIND_IDS)
def test_sample_bsdf(k, side):
    jt, tt = _tables()
    mid, kd = _inputs(k, textured=True)
    u2 = np.random.RandomState(4).rand(N, 2).astype(np.float32)
    ja, ta = _args(mid, kd, _dirs(3, upper=side == "outside"), u2)
    js = jb.sample_bsdf(jt, *ja)
    ts = tb.sample_bsdf(tt, *ta)
    for name in js._fields:
        _close(getattr(ts, name), getattr(js, name), atol=LIFT_ATOL)


def test_emission():
    jt, tt = _tables()
    mid = np.arange(N, dtype=np.int32) % len(_MATS)
    np.testing.assert_array_equal(
        tb.emission(tt, torch.from_numpy(mid)).numpy(),
        np.asarray(jb.emission(jt, jnp.asarray(mid))))
