"""The CUDA graphs of `render_chunk`'s batches (integrators/graphs.py) on
the CPU: which batches run eagerly, are captured or are replayed (device,
autograd, signature, comparison harnesses); CPU batches never reach
`torch.cuda`; and the telemetry record that a capture fills, which each
replay adds into the counters only while a profiler runs.  The graphs
themselves run on the card: tests/test_torch_graph_cuda.py."""
from __future__ import annotations

from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bpt_tpu_torch import telemetry
from bpt_tpu_torch.accel import api
from bpt_tpu_torch.core import rng
from bpt_tpu_torch.integrators import bdpt, graphs
from bpt_tpu_torch.ops import trace_closest
from bpt_tpu_torch.scene.procedural import cornell_box_scene
from test_torch_bdpt import _one_thread  # noqa: F401  (a fixture)

W = H = 8
CFG = bdpt.BDPTConfig(W, H, spp=6, rr_depth=3)
CUDA = torch.device("cuda")


@pytest.fixture(scope="module")
def box():
    scene, _, cam = cornell_box_scene(W, H, device="cpu",
                                      right_object="glass_sphere")
    return scene, cam.device_constants("cpu")


def _loop(scene, cc, cfg, key, spp, sb):
    """render_chunk's batches, one eager call each."""
    pixel_idx = bdpt._blocked_pixel_order(cfg.width, cfg.height, "cpu")
    fb = torch.zeros((cfg.width * cfg.height, 3))
    nrays = 0
    for bi in range(spp // sb):
        pix, lkeys = bdpt.sample_lane_keys(key, pixel_idx,
                                           bi * sb + torch.arange(sb))
        fb_s, nr = bdpt.render_sample(scene, cc, cfg, key, pix, lkeys=lkeys)
        fb = fb + fb_s
        nrays += int(nr)
    return fb, nrays


def _refuse(*_, **__):
    raise AssertionError("a CPU render reached torch.cuda")


def test_cpu_batches_never_reach_the_card(box):
    scene, cc = box
    key = rng.key(3, "cpu")
    before = graphs.CACHE.signature
    with mock.patch.multiple(torch.cuda, CUDAGraph=_refuse, graph=_refuse,
                             synchronize=_refuse, current_stream=_refuse):
        fb, nrays = bdpt.render_chunk(scene, cc, CFG, key, 6,
                                      samples_per_batch=2)
    assert graphs.CACHE.signature is before
    want, want_n = _loop(scene, cc, CFG, key, 6, 2)
    assert torch.equal(fb, want) and int(nrays) == want_n


def test_cpu_batches_count_as_eager(box):
    scene, cc = box
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        bdpt.render_chunk(scene, cc, CFG, rng.key(3, "cpu"), 6,
                          samples_per_batch=2)
    snap = telemetry.snapshot()
    telemetry.reset()
    assert snap["bdpt.graph.eager"] == 3
    assert "bdpt.graph.capture" not in snap
    assert "bdpt.graph.replay" not in snap


@pytest.mark.parametrize("device,grad,requires,eager", [
    ("cpu", False, False, True),
    ("cpu", True, True, True),
    ("cuda", False, False, False),
    ("cuda", True, False, False),
    ("cuda", False, True, False),
    ("cuda", True, True, True),
], ids=["cpu", "cpu-grad", "cuda", "cuda-grad-mode", "cuda-no-grad-mode",
        "cuda-grad"])
def test_eager_by_device_and_autograd(device, grad, requires, eager):
    """Eager off the card, and where autograd records the batch: grad
    mode on and a tensor it reads requires a gradient."""
    reads = [torch.ones(2), torch.ones(3, requires_grad=requires)]
    with torch.set_grad_enabled(grad):
        assert graphs.needs_eager(device, reads) is eager


def test_plan_warms_captures_then_replays():
    g = graphs.BatchGraphs()
    assert [g.plan("a") for _ in range(4)] == ["warm", "capture", "replay",
                                               "replay"]
    # A new signature starts over and drops the old one.
    assert [g.plan("b") for _ in range(3)] == ["warm", "capture", "replay"]
    assert [g.plan("a") for _ in range(2)] == ["warm", "capture"]


def test_a_comparison_harness_keeps_its_signature_eager(monkeypatch):
    """A first batch that calls a plain version on CUDA tensors leaves its
    signature eager; the eager batches run the batch and nothing else."""
    monkeypatch.setattr(trace_closest.closest_hit_plain, "cuda_calls",
                        trace_closest.closest_hit_plain.cuda_calls)
    calls = []

    def harness(key, sids):
        trace_closest.closest_hit_plain.cuda_calls += 1
        calls.append(int(sids[0]))
        return key, sids

    g = graphs.BatchGraphs()
    for i in range(3):
        g.run("s", None, harness, torch.zeros(2), torch.tensor([i]))
    assert calls == [0, 1, 2] and g.plan("s") == "eager"
    assert g.graph is None


def test_signature(box):
    """Equal for the same inputs; another for a scene of other tensors,
    another configuration, batch size, pixel shard of the same lanes,
    trace or RNG route or lane budget."""
    scene, cc = box
    reads = graphs.tensors((scene, cc))
    assert len(reads) > 30 and all(torch.is_tensor(t) for t in reads)

    def sig(sc=scene, cfg=CFG, sb=2, shard=(0, 1)):
        return graphs.signature(CUDA, graphs.tensors((sc, cc)), cfg,
                                W * H * sb // shard[1], sb, shard)

    base = sig()
    assert sig() == base
    assert graphs.signature(CUDA, reads, CFG, W * H * 2, 2) == base
    assert sig(sc=scene._replace(n0=scene.n0.clone())) != base
    assert sig(cfg=bdpt.BDPTConfig(W, H, spp=6, rr_depth=4)) != base
    assert sig(sb=1) != base
    assert sig(sb=4, shard=(0, 2)) != sig(sb=4, shard=(1, 2))
    with mock.patch.object(api, "closest_hit",
                           trace_closest.closest_hit_plain):
        assert sig() != base
    with mock.patch.object(rng, "uniform2", rng.uniform2_plain):
        assert sig() != base
    with mock.patch.object(bdpt, "MEGA_MAX_LANES", 4_000):
        assert sig() != base
    assert sig() == base


def test_attribute_counters_cover_every_wrapper():
    from bpt_tpu_torch.ops import gather, threefry, trace_any

    names = {(fn.__name__, attr) for fn, attr in graphs.attribute_counters()}
    assert {("closest_hit", "launches"), ("any_hit", "launches"),
            ("closest_hit_stream", "launches"),
            ("any_hit_stream", "launches"),
            ("gather_rows_backward", "launches"),
            ("threefry_cuda", "launches"),
            ("closest_hit_plain", "cuda_calls"),
            ("any_hit_plain", "cuda_calls"),
            ("fold_in_plain", "cuda_calls"),
            ("uniform2_plain", "cuda_calls")} <= names
    assert (threefry.threefry_cuda, "launches") in graphs.attribute_counters()
    assert (gather.gather_rows_backward_plain, "cuda_calls") in \
        graphs.attribute_counters()
    assert (trace_any.any_hit_compact, "launches") in \
        graphs.attribute_counters()


def _record():
    """A record of two host counts and one device count."""
    live = torch.tensor(5)
    with telemetry.recording() as rec:
        assert telemetry.counting()
        telemetry.add("trace.lanes.any", 8)
        telemetry.add("trace.lanes.any", 2)
        telemetry.add_device("trace.live.any", live)
    return rec, live


def test_recording_keeps_counts_out_of_the_counters():
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        rec, _ = _record()
    assert telemetry.snapshot() == {}
    assert rec.counts == {"trace.lanes.any": 10}
    assert list(rec.device) == ["trace.live.any"]


def test_replay_counts_only_under_a_profiler():
    telemetry.reset()
    rec, live = _record()
    assert not telemetry.counting()
    rec.replay()
    assert telemetry.snapshot() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        rec.replay()
        live.fill_(7)  # the graph rewrites its count at the next replay
        rec.replay()
    rec.replay()
    snap = telemetry.snapshot()
    telemetry.reset()
    assert snap == {"trace.lanes.any": 20, "trace.live.any": 12}
