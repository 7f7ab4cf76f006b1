"""The technique toggles of the ported BDPT (`connect_t1`, `connect_s1`,
`connect_s2`, `trace_vis`) against the reference package's on the CPU
(the reference through its XLA tracer, the port through its plain trace
versions), from the same scene arrays, walk outputs and seed.

`_mega_connect` is held to rtol 1e-4 / atol 1e-6 with pixels and ray
counts exact; whole renders on aggregates (`_gate`)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from bpt_tpu.integrators import bdpt as jb
from bpt_tpu_torch.integrators import bdpt as tb
from test_torch_bdpt import (  # noqa: F401  (_one_thread: a fixture)
    _gate, _one_thread, _pair)
from test_torch_rr import walk_outputs  # noqa: F401  (a fixture)

_OFF = [dict(connect_t1=False), dict(connect_s1=False),
        dict(connect_s2=False), dict(trace_vis=False)]
_IDS = ["t1", "s1", "s2", "trace_vis"]


# budget 1,000 lanes: the 2,304-lane pair grid goes in three chunks.
@pytest.mark.parametrize("off,budget", [(o, None) for o in _OFF]
                         + [(dict(trace_vis=False), 1000)],
                         ids=_IDS + ["trace_vis_chunked"])
def test_toggled_mega_connect_matches_reference(walk_outputs, off, budget,
                                                monkeypatch):
    """Both packages' _mega_connect with one technique switched off, on
    the same walk outputs; t1_ok is None without t=1, as render_sample
    passes it."""
    (js, jcc, cfg_j, j_args), (ts, tcc, cfg_t, t_args) = walk_outputs
    if budget is not None:
        monkeypatch.setattr(jb, "_MEGA_MAX_LANES", budget)
        monkeypatch.setattr(tb, "MEGA_MAX_LANES", budget)
    cfg_j = dataclasses.replace(cfg_j, **off)
    cfg_t = dataclasses.replace(cfg_t, **off)
    if not cfg_t.connect_t1:
        j_args, t_args = j_args[:-1] + (None,), t_args[:-1] + (None,)
    jli, jspix, jsrgb, jn = jb._mega_connect(js, jcc, cfg_j, *j_args)
    tli, tspix, tsrgb, tn = tb._mega_connect(ts, tcc, cfg_t, *t_args)
    assert int(tn) == int(jn)
    assert (int(tn) == 0) == (not cfg_t.trace_vis)
    np.testing.assert_array_equal(tspix.numpy(), np.asarray(jspix))
    np.testing.assert_allclose(tsrgb.numpy(), np.asarray(jsrgb), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tli.numpy(), np.asarray(jli), rtol=1e-4,
                               atol=1e-6)
    if not cfg_t.connect_t1:
        assert float(tsrgb.abs().sum()) == 0.0


# The walks' own branches of the toggles: BDPT's fused walks without t=1
# splats or NEE rows, the solo walks without their in-walk traces.
# connect_s2 and BDPT's trace_vis act only in _mega_connect (above).
_RENDERS = {"bdpt_t1": dict(mode="bdpt", connect_t1=False),
            "bdpt_s1": dict(mode="bdpt", connect_s1=False),
            "light_trace_t1": dict(mode="light_trace", connect_t1=False),
            "light_trace_trace_vis": dict(mode="light_trace",
                                          trace_vis=False),
            "path_trace_s1": dict(mode="path_trace", connect_s1=False),
            "path_trace_trace_vis": dict(mode="path_trace",
                                         trace_vis=False)}


@pytest.mark.parametrize("cfg", _RENDERS.values(), ids=_RENDERS.keys())
def test_toggled_render_image_matches_reference(cfg):
    """render_image with one technique switched off."""
    js, jc, ts, tc = _pair(16)
    # Two jittered samples: pixel-centre rays (spp 1) meet triangle edges
    # exactly, where the two packages' tracers may break the tie apart.
    cfg = dict(spp=2, rr_depth=3, **cfg)
    ji, jn = jb.render_image(js, jc, jb.BDPTConfig(16, 16, **cfg), seed=1)
    ti, tn = tb.render_image(ts, tc, tb.BDPTConfig(16, 16, **cfg), seed=1)
    ti = ti.numpy()
    assert ti.shape == (16, 16, 3) and np.isfinite(ti).all()
    assert ti.mean() > 0.0
    _gate(ti, np.asarray(ji), tn, jn)
