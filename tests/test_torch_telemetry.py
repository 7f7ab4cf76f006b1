"""The port's spans and counters (bpt_tpu_torch/telemetry.py) on the CPU:
nothing is recorded or counted without a profiler, every span of the BDPT
main path and of a descent step is recorded under one, the lane counters
agree with the lanes the traces were handed, and a profiled render is
bit-equal to an unprofiled one."""
from __future__ import annotations

from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bpt_tpu_torch import telemetry
from bpt_tpu_torch.accel import api
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.diff import grad, inverse
from bpt_tpu_torch.integrators import bdpt
from bpt_tpu_torch.scene.procedural import cornell_box_scene
from test_torch_bdpt import _one_thread  # noqa: F401  (a fixture)

W = H = 16
CFG = bdpt.BDPTConfig(W, H, spp=2, rr_depth=3)
BDPT_SPANS = {"bpt.bdpt.render_chunk", "bpt.bdpt.batch", "bpt.bdpt.walks",
              "bpt.bdpt.connect", "bpt.bdpt.splat", "bpt.rng",
              "bpt.accel.trace_closest", "bpt.accel.trace_any",
              "bpt.accel.compact", "bpt.accel.kernel",
              "bpt.accel.uncompact", "bpt.count"}
DIFF_SPANS = {"bpt.diff.forward", "bpt.diff.backward", "bpt.diff.update"}


@pytest.fixture(scope="module")
def box():
    scene, _, cam = cornell_box_scene(W, H, device="cpu",
                                      right_object="glass_sphere")
    return scene, cam


def _chunk(box):
    scene, cam = box
    return bdpt.render_chunk(scene, cam.device_constants("cpu"), CFG,
                             rng.key(5, "cpu"), 2, samples_per_batch=2)


def _host_spans(prof):
    """(name, start, end) of every host range whose name starts "bpt."."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(telemetry.PREFIX)]


@pytest.fixture(scope="module")
def profiled(box):
    """One chunk under the profiler, with the lanes each trace was handed
    recorded beside the counters: (framebuffer, nrays, spans, counters,
    handed)."""
    handed = {"closest": [0, 0], "any": [0, 0]}
    inner = api.compact_rays

    def recorded(o, d, min_t, max_t, bounds=None, kind="segment"):
        out = inner(o, d, min_t, max_t, bounds=bounds, kind=kind)
        n = handed["closest" if kind == "ray" else "any"]
        n[0] += o.shape[0]
        n[1] += int(out[-1].valid.sum())
        return out

    telemetry.reset()
    with mock.patch.object(api, "compact_rays", recorded), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        fb, nrays = _chunk(box)
    counters = telemetry.snapshot()
    telemetry.reset()
    return fb, nrays, _host_spans(prof), counters, handed


def test_no_profiler_no_span_and_no_count(box):
    assert not telemetry.active()
    assert telemetry.span("bdpt.walks") is telemetry.span("rng")
    telemetry.reset()
    _chunk(box)
    telemetry.add("trace.lanes.closest", 7)
    telemetry.add_device("trace.live.closest", torch.tensor(3))
    assert telemetry.snapshot() == {}


def test_profiled_chunk_records_every_span(profiled):
    names = {n for n, _, _ in profiled[2]}
    assert BDPT_SPANS <= names, BDPT_SPANS - names


def test_rng_spans_never_nest(profiled):
    rngs = sorted((s, e) for n, s, e in profiled[2] if n == "bpt.rng")
    assert rngs
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(rngs, rngs[1:]))


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_lane_counters_match_the_lanes_handed(profiled, kind):
    counters, handed = profiled[3], profiled[4]
    lanes, live = handed[kind]
    assert lanes > 0 and 0 < live <= lanes
    assert counters[f"trace.lanes.{kind}"] == lanes
    assert counters[f"trace.live.{kind}"] == live
    assert isinstance(counters[f"trace.live.{kind}"], int)


def test_profiled_render_is_bit_equal(box, profiled):
    fb, nrays = _chunk(box)
    assert torch.equal(fb, profiled[0])
    assert int(nrays) == int(profiled[1])


def test_descent_step_records_the_diff_spans(box):
    scene, cam = box
    target = grad.render_with_params(
        grad.extract_params(scene), scene, cam.device_constants("cpu"), CFG,
        rng.key(3, "cpu"), 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inverse.recover_materials(scene, cam, CFG, target, iterations=1,
                                  spp_chunk=2, seed=7)
    names = [n for n, _, _ in _host_spans(prof)]
    for span in DIFF_SPANS:
        assert names.count(span) == 1, (span, names.count(span))


def test_timed_adds_up_without_a_profiler():
    telemetry.reset()
    for _ in range(2):
        with telemetry.timed("setup.x_s"):
            pass
    cornell_box_scene(8, 8, device="cpu")
    snap = telemetry.snapshot()
    telemetry.reset()
    assert set(snap) == {"setup.x_s", "setup.scene_build_s"}
    assert snap["setup.x_s"] >= 0.0 and snap["setup.scene_build_s"] > 0.0
