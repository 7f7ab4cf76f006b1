"""The solo subpath walks and the light_trace / path_trace modes of the
ported BDPT against the reference package on the CPU (the reference
through its XLA tracer, the port through its plain trace versions), from
the same scene arrays, lane keys and seed.

Per-call outputs are held to rtol 1e-4 / atol 1e-5 with flags, pixels and
triangle ids exact; whole renders on aggregates (`_gate`)."""
from __future__ import annotations

import numpy as np
import pytest

from bpt_tpu.integrators import bdpt as jb
from bpt_tpu_torch.integrators import bdpt as tb
from test_torch_bdpt import (  # noqa: F401  (_one_thread: a fixture)
    _assert_slots_match, _gate, _one_thread, _pair, _primaries)


def _close(t, j, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                               atol=atol)


@pytest.mark.parametrize("mode", ["bdpt", "light_trace"])
def test_light_subpath_walk_matches_reference(mode):
    """light_subpath_walk with its t=1 occlusion traced in the walk: the
    final splats (MIS-weighted in BDPT mode only) and the slots."""
    (js, jcc, cfg_j, jk, _, ja, ts, tcc, cfg_t, tk, _,
     ta) = _primaries(mode=mode)
    jslots, jpix, jrgb, jn = jb.light_subpath_walk(js, jcc, cfg_j, jk, 256,
                                                   ja)
    tslots, tpix, trgb, tn = tb.light_subpath_walk(ts, tcc, cfg_t, tk, 256,
                                                   ta)
    assert int(tn) == int(jn)
    _assert_slots_match(tslots, jslots)
    np.testing.assert_array_equal(tpix.numpy(), np.asarray(jpix))
    _close(trgb, jrgb)
    assert int((tpix < 256).sum()) > 0


@pytest.mark.parametrize("mode", ["bdpt", "path_trace"])
def test_eye_subpath_walk_matches_reference(mode):
    """eye_subpath_walk with NEE traced in the walk: s=0 and NEE radiance
    (MIS-weighted in BDPT mode only) and the rays traced."""
    (js, jcc, cfg_j, jk, jd, _, ts, tcc, cfg_t, tk, td,
     _) = _primaries(mode=mode)
    jli, jn = jb.eye_subpath_walk(js, jcc, cfg_j, jk, jd, None)
    tli, tn = tb.eye_subpath_walk(ts, tcc, cfg_t, tk, td)
    assert int(tn) == int(jn)
    _close(tli, jli)
    assert float(tli.sum()) > 0.0


@pytest.mark.parametrize("mode", ["light_trace", "path_trace"])
def test_mode_render_image_matches_reference(mode):
    js, jc, ts, tc = _pair(16)
    cfg = dict(spp=2, rr_depth=4, mode=mode)
    ji, jn = jb.render_image(js, jc, jb.BDPTConfig(16, 16, **cfg), seed=1)
    ti, tn = tb.render_image(ts, tc, tb.BDPTConfig(16, 16, **cfg), seed=1)
    ti = ti.numpy()
    assert ti.shape == (16, 16, 3) and np.isfinite(ti).all()
    assert ti.mean() > 0.0
    _gate(ti, np.asarray(ji), tn, jn)
