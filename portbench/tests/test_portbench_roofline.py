"""The benchmark's frozen copy of the trace bound equals chip_smoke.py's
on a small table, and its share arithmetic is bound / time."""
from __future__ import annotations

import pytest
import torch

from portbench.harness import roofline
from portbench.reference.bpt.scene.procedural import cornell_box_scene


@pytest.fixture(scope="module")
def scene():
    s, _, cam = cornell_box_scene(16, 16, device="cpu",
                                  right_object="glass_sphere",
                                  sphere_subdiv=1)
    return s, cam


def _args_closest(scene, cam, gen):
    return roofline.camera_rays(scene, cam, 1024, gen, "cpu")


def _args_any(scene, cam, gen):
    return roofline.segments(scene, 2048, 0.3, gen, "cpu")


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_bound_equals_chip_smoke(scene, kind):
    import chip_smoke
    from portbench.reference.bpt.ops.trace_any import any_hit
    from portbench.reference.bpt.ops.trace_closest import closest_hit

    s, cam = scene
    gen = torch.Generator().manual_seed(3)
    if kind == "closest":
        args = _args_closest(s, cam, gen)
        tg = s.treelets
        result = closest_hit(tg, *args)
    else:
        args = _args_any(s, cam, gen)
        tg = s.treelets_any
        result = any_hit(tg, *args)
    ours = roofline.trace_bound(tg, args, kind, result)
    theirs = chip_smoke.trace_bound(tg, args, kind, result)
    assert ours["fp32_ops"] > 0
    for k in ours:
        assert ours[k] == theirs[k]
    assert (roofline.treelet_sizes(tg) == chip_smoke.treelet_sizes(tg)).all()


def test_constants_equal_chip_smoke():
    import chip_smoke

    assert (roofline.OPS_SLAB, roofline.OPS_MT, roofline.PEAK_FP32_OPS,
            roofline.PEAK_BYTES) == (chip_smoke.OPS_SLAB, chip_smoke.OPS_MT,
                                     chip_smoke.PEAK_FP32_OPS,
                                     chip_smoke.PEAK_BYTES)


def test_probe_inputs_have_the_cell_shapes(scene):
    s, cam = scene
    gen = torch.Generator().manual_seed(4)
    o, d, mn, mx = _args_closest(s, cam, gen)
    assert o.shape == d.shape == (1024, 3) and (mx > mn).all()
    o, d, mn, mx = _args_any(s, cam, gen)
    live = (mx >= mn).double().mean()
    assert o.shape == (2048, 3) and 0.2 < float(live) < 0.4
