"""`render_chunk`'s batches through CUDA graphs (integrators/graphs.py) on
the card: chunk after chunk equal to the test's own eager loop over
`sample_lane_keys` and `render_sample` (the same ray count, the
framebuffer within the t=1 splats' index_add_ atomics), in every mode
`render_chunk` takes, NO_RR and Russian roulette; the batches counted as
eager, captured and replayed; every counter reading the same after a
replayed chunk as after the eager loop; a new scene or configuration
capturing anew; and a batch whose parameters require a gradient running
eagerly, with the eager loop's gradient.  These need an NVIDIA GPU with
nvcc and skip without one; run them on the card with

    python -m pytest tests/test_torch_graph_cuda.py -q -m cuda --noconftest
"""
from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

pytestmark = pytest.mark.cuda

W = 64
SB = 2
CHUNK = 8
COUNTERS = ("trace.lanes.closest", "trace.lanes.any", "trace.live.closest",
            "trace.live.any", "rng.calls.kernel", "rng.calls.plain")
# Every mode render_chunk takes, NO_RR (the caustic cell's rr_depth 8) and
# with Russian roulette.
MODES = {"bdpt": dict(rr_depth=8),
         "light_trace": dict(rr_depth=8, mode="light_trace"),
         "path_trace": dict(rr_depth=8, mode="path_trace"),
         "bdpt_rr": dict(rr_depth=3, no_rr=False, max_bounces=6),
         "light_trace_rr": dict(rr_depth=3, no_rr=False, max_bounces=6,
                                mode="light_trace"),
         "path_trace_rr": dict(rr_depth=3, no_rr=False, max_bounces=6,
                               mode="path_trace")}


@pytest.fixture(scope="module")
def box():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    scene, _, cam = cornell_box_scene(W, W, device="cuda",
                                      right_object="glass_sphere",
                                      sphere_subdiv=3)
    return scene, cam.device_constants("cuda")


@pytest.fixture
def graphs(monkeypatch):
    """integrators/graphs.py with an empty cache."""
    from bpt_tpu_torch.integrators import graphs

    monkeypatch.setattr(graphs, "CACHE", graphs.BatchGraphs())
    return graphs


def _cfg(mode="bdpt"):
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig

    return BDPTConfig(W, W, spp=1024, **MODES[mode])


def _key():
    from bpt_tpu_torch.core import rng

    return rng.key(2147483901, "cuda")


def _chunk(scene, cc, cfg, offset, key=None):
    from bpt_tpu_torch.integrators.bdpt import render_chunk

    fb, nrays = render_chunk(scene, cc, cfg, key if key is not None
                             else _key(), CHUNK, sample_offset=offset,
                             samples_per_batch=SB)
    return fb, int(nrays)


def _loop(scene, cc, cfg, offset, key=None):
    """The chunk's batches, each one eager call of sample_lane_keys and
    render_sample."""
    from bpt_tpu_torch.integrators import bdpt

    key = key if key is not None else _key()
    pixel_idx = bdpt._blocked_pixel_order(W, W, "cuda")
    fb = torch.zeros((W * W, 3), device="cuda")
    nrays = torch.zeros((), dtype=torch.int64, device="cuda")
    for bi in range(CHUNK // SB):
        sids = offset + bi * SB + torch.arange(SB, device="cuda")
        pix, lkeys = bdpt.sample_lane_keys(key, pixel_idx, sids)
        fb_s, nr = bdpt.render_sample(scene, cc, cfg, key, pix, lkeys=lkeys)
        fb = fb + fb_s
        nrays = nrays + nr
    return fb, int(nrays)


def _assert_same(got, want):
    """The same rays; each pixel within the t=1 splats' atomics (sums of
    non-negative splats in another order), as tests/test_torch_rng_cuda.py
    holds the plain RNG route."""
    (fb, n), (fb_w, n_w) = got, want
    assert n == n_w
    assert float(fb_w.abs().mean()) > 0
    assert torch.allclose(fb, fb_w, rtol=1e-5,
                          atol=1e-6 * float(fb_w.abs().mean()))


def _counted(fn):
    """fn() under a profiler, from reset counters: (its result, the
    telemetry counters, the change of every attribute counter)."""
    from bpt_tpu_torch import telemetry
    from bpt_tpu_torch.integrators import graphs

    torch.cuda.synchronize()
    telemetry.reset()
    before = graphs.attribute_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
        torch.cuda.synchronize()
    snap = telemetry.snapshot()
    telemetry.reset()
    after = graphs.attribute_counters()
    return out, snap, {c: n - before.get(c, 0) for c, n in after.items()}


def _how(snap):
    return tuple(snap.get(f"bdpt.graph.{k}", 0)
                 for k in ("replay", "capture", "eager"))


@pytest.mark.parametrize("mode", list(MODES))
def test_chunks_equal_the_eager_loop(box, graphs, mode):
    """Two chunks in a row (the first warms, captures and replays, the
    second only replays) against the eager loop."""
    scene, cc = box
    cfg = _cfg(mode)
    for offset in (0, CHUNK):
        _assert_same(_chunk(scene, cc, cfg, offset),
                     _loop(scene, cc, cfg, offset))
    assert graphs.CACHE.graph is not None


def test_batches_counted_by_how_they_ran(box, graphs):
    scene, cc = box
    cfg = _cfg()
    _, first, _ = _counted(lambda: _chunk(scene, cc, cfg, 0))
    _, second, _ = _counted(lambda: _chunk(scene, cc, cfg, CHUNK))
    assert _how(first) == (2, 1, 1)
    assert _how(second) == (4, 0, 0)


def test_counters_after_a_replayed_chunk_equal_the_eager_loop(box, graphs):
    scene, cc = box
    cfg = _cfg()
    _chunk(scene, cc, cfg, 0)
    got, snap, attrs = _counted(lambda: _chunk(scene, cc, cfg, CHUNK))
    want, snap_w, attrs_w = _counted(lambda: _loop(scene, cc, cfg, CHUNK))
    assert _how(snap) == (4, 0, 0)
    _assert_same(got, want)
    for name in COUNTERS:
        assert snap.get(name) == snap_w.get(name), name
    assert snap["trace.lanes.any"] > 0 and snap["rng.calls.kernel"] > 0
    assert attrs == attrs_w
    launched = {fn.__name__: n for (fn, attr), n in attrs.items()
                if attr == "launches" and n}
    assert set(launched) == {"closest_hit", "any_hit", "threefry_cuda"}
    assert not any(n for (_, attr), n in attrs.items()
                   if attr == "cuda_calls")


def test_a_new_scene_or_config_captures_anew(box, graphs):
    scene, cc = box
    cfg = _cfg()
    _chunk(scene, cc, cfg, 0)
    other = scene._replace(mat=scene.mat._replace(
        diffuse=scene.mat.diffuse.clone()))
    (fb, n), snap, _ = _counted(lambda: _chunk(other, cc, cfg, CHUNK))
    assert _how(snap) == (2, 1, 1)
    _assert_same((fb, n), _loop(scene, cc, cfg, CHUNK))
    cfg7 = dataclasses.replace(cfg, rr_depth=7)
    _, snap, _ = _counted(lambda: _chunk(other, cc, cfg7, CHUNK))
    assert _how(snap) == (2, 1, 1)
    _, snap, _ = _counted(lambda: _chunk(other, cc, cfg7, 2 * CHUNK))
    assert _how(snap) == (4, 0, 0)


def test_a_batch_that_needs_a_gradient_runs_eagerly(box, graphs):
    """The descent's case: parameters that require a gradient under grad
    mode.  Every batch eager, the graph cache left alone, and the gradient
    of the eager loop's."""
    from bpt_tpu_torch.diff.grad import apply_params, extract_params

    scene, cc = box
    cfg = _cfg()
    params = extract_params(scene)

    def grad_of(render):
        leaves = {f: p.detach().requires_grad_(True)
                  for f, p in params.items()}
        fb, _ = render(apply_params(scene, leaves), cc, cfg, 0)
        loss = (fb ** 2).mean()
        return dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))

    got, snap, _ = _counted(lambda: grad_of(_chunk))
    want = grad_of(_loop)
    assert _how(snap) == (0, 0, CHUNK // SB)
    assert graphs.CACHE.signature is None
    for f, g in got.items():
        if want[f] is None:
            assert g is None
            continue
        assert torch.isfinite(g).all()
        assert float(torch.linalg.vector_norm((g - want[f]).double())) <= \
            1e-5 * float(torch.linalg.vector_norm(want[f].double()))
    assert float(got["emission"].abs().sum()) > 0
