"""Russian-roulette walks and the chunked pair connect of the ported BDPT
against the reference package on the CPU (the reference through its XLA
tracer, the port through its plain trace versions), from the same scene
arrays, lane keys and seed.

Per-call outputs are held to rtol 1e-4 / atol 1e-5 with flags, pixels and
triangle ids exact; whole renders on aggregates (`_gate`)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.integrators import bdpt as jb
from bpt_tpu_torch.integrators import bdpt as tb
from test_torch_bdpt import (  # noqa: F401  (_one_thread: a fixture)
    _assert_walks_match, _gate, _one_thread, _pair, _walks)

RR = dict(no_rr=False, rr_depth=2, max_bounces=6)


@pytest.mark.parametrize("rr_depth", [2, 4])
def test_rr_probability_matches_reference(rr_depth):
    """The luminance gate on seeded throughputs (luminance from ~1e-4 to
    ~1) at depths on both sides of rr_depth, and NO_RR mode, exactly."""
    thr = np.exp(np.random.default_rng(rr_depth).uniform(
        -9.0, 0.0, size=(4096, 3))).astype(np.float32)
    seen = set()
    for no_rr in (False, True):
        for depth in range(1, rr_depth + 3):
            kw = dict(rr_depth=rr_depth, no_rr=no_rr)
            j = np.asarray(jb._rr_probability(
                jb.BDPTConfig(8, 8, 1, **kw), depth, jnp.asarray(thr)))
            t = tb._rr_probability(tb.BDPTConfig(8, 8, 1, **kw), depth,
                                   torch.from_numpy(thr)).numpy()
            np.testing.assert_array_equal(t, j)
            seen.update(np.unique(t).tolist())
    assert seen == {0.5, 1.0}


def test_fused_subpath_walks_match_reference_in_rr_mode():
    """fused_subpath_walks with Russian roulette (rr_depth 2, 4 bounces)
    at the same lane keys and primary rays: every per-depth output.  The
    all-diffuse box with a dim emitter (emission 0.01): the light walks'
    throughput luminance starts below 0.01, so roulette halves them from
    the second bounce on.  (Past four bounces a few vcm values drift
    beyond rtol 1e-4 through the ulp differences of the two tracers.)"""
    _, _, _, jout, _, _, _, tout = _walks(scene=dict(emission=0.01),
                                          no_rr=False, rr_depth=2,
                                          max_bounces=4)
    _assert_walks_match(jout, tout)
    light_slots = tout[0]
    assert float(light_slots.rr.min()) == 0.5
    alive = light_slots.valid.sum(dim=1).tolist()
    assert alive == sorted(alive, reverse=True) and alive[-1] < alive[0] / 4


def test_rr_render_image_matches_reference():
    js, jc, ts, tc = _pair(16)
    cfg = dict(spp=2, **RR)
    ji, jn = jb.render_image(js, jc, jb.BDPTConfig(16, 16, **cfg), seed=1)
    ti, tn = tb.render_image(ts, tc, tb.BDPTConfig(16, 16, **cfg), seed=1)
    ti = ti.numpy()
    assert ti.shape == (16, 16, 3) and np.isfinite(ti).all()
    _gate(ti, np.asarray(ji), tn, jn)


@pytest.fixture(scope="module")
def walk_outputs():
    """The reference's walk outputs (rr_depth 4: L = 3, B = 256, a pair
    grid of 2,304 lanes) as both packages' arguments to _mega_connect."""
    js, jcc, cfg_j, jout, ts, tcc, cfg_t, _ = _walks()
    (jl, jpix, jrgb, jok, _, je, (jnee_li, jnee_ok, jnee_end), _) = jout
    j_args = (je, jl, jnee_li, jnee_ok, jnee_end, jpix, jrgb, jok)

    def t(a):
        return torch.from_numpy(np.array(a))

    t_args = (tb.LightVertexSlots(*(t(a) for a in je)),
              tb.LightVertexSlots(*(t(a) for a in jl)), t(jnee_li),
              t(jnee_ok), t(jnee_end), t(jpix), t(jrgb), t(jok))
    return (js, jcc, cfg_j, j_args), (ts, tcc, cfg_t, t_args)


# 1,000 lanes: three chunks of one eye row (768 lanes); 1,600: a chunk of
# two rows, then a ragged one of one row.
@pytest.mark.parametrize("budget", [1000, 1600])
def test_chunked_mega_connect_matches_reference(walk_outputs, budget,
                                                monkeypatch):
    """Both packages' _mega_connect with the lane budget below the pair
    grid, so both trace the pairs in chunks of eye-depth rows."""
    (js, jcc, cfg_j, j_args), (ts, tcc, cfg_t, t_args) = walk_outputs
    monkeypatch.setattr(jb, "_MEGA_MAX_LANES", budget)
    monkeypatch.setattr(tb, "MEGA_MAX_LANES", budget)
    launches = []
    trace_any = tb.trace_any
    monkeypatch.setattr(tb, "trace_any", lambda *a: launches.append(
        a[1].shape[0]) or trace_any(*a))
    jli, jspix, jsrgb, jn = jb._mega_connect(js, jcc, cfg_j, *j_args)
    tli, tspix, tsrgb, tn = tb._mega_connect(ts, tcc, cfg_t, *t_args)
    # One NEE + t=1 trace of 2 x 768 lanes, then the row chunks.
    c = budget // 768
    assert launches == [1536] + [c * 768] * (3 // c) + [768] * (3 % c)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(tspix.numpy(), np.asarray(jspix))
    np.testing.assert_allclose(tsrgb.numpy(), np.asarray(jsrgb), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tli.numpy(), np.asarray(jli), rtol=1e-4,
                               atol=1e-6)


def test_chunked_connect_equals_the_single_trace(walk_outputs, monkeypatch):
    """The port's chunked pair connect against its one-trace connect on
    the same walk outputs: equal to summation order."""
    _, (ts, tcc, cfg_t, t_args) = walk_outputs
    one = tb._mega_connect(ts, tcc, cfg_t, *t_args)
    monkeypatch.setattr(tb, "MEGA_MAX_LANES", 1000)
    chunked = tb._mega_connect(ts, tcc, cfg_t, *t_args)
    assert int(chunked[3]) == int(one[3])
    assert torch.equal(chunked[1], one[1])
    torch.testing.assert_close(chunked[2], one[2], rtol=0.0, atol=0.0)
    torch.testing.assert_close(chunked[0], one[0], rtol=1e-5, atol=1e-7)
    assert float(one[0].sum()) > 0.0
