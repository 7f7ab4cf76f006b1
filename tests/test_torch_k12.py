"""What the redesigned K1 (closest hit) and K2 (any hit) kernels rest on,
checked on the CPU: the packed triangle rows they read hold exactly the
table's triangles, pad slots never hit, K2's flags do not depend on the
treelet order, and both wrappers still compute the reference kernels'
functions (trace_closest_compact, trace_any_sweep in interpret mode) on
a second table.  Also the default device of `rng.key`."""
from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import chip_smoke
from bpt_tpu.ops import pallas_sweep, pallas_trace
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.accel.treelets import (TreeletGeom, packed_triangles,
                                          triangle_counts)
from bpt_tpu_torch.core import rng as trng
from bpt_tpu_torch.ops.intersect import moller_trumbore
from bpt_tpu_torch.ops.trace_any import any_hit, any_hit_plain
from bpt_tpu_torch.ops.trace_closest import closest_hit, closest_hit_plain
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays
from test_torch_trace import _assert_closest_equal, _jax, _rays, _torch

TABLES = {"bench": 3, "subdiv4": 4}
# atol of u and v against the interpret-mode reference, which runs on
# XLA:CPU and may contract multiply-adds: tests/test_torch_trace.py's 1e-5
# on the bench table; the subdiv-4 sphere's triangles have half the edge
# and a quarter of the |det|, which amplifies the same few ulp of the
# numerator four times (1.2e-5 measured).
UV_ATOL = {"bench": 1e-5, "subdiv4": 4e-5}


@pytest.fixture(scope="module", params=list(TABLES))
def scenes(request):
    """(reference scene, port scene) of the glass box, the bench table
    (19 treelets) or the subdiv-4 one."""
    js, _, _ = jax_cbox(32, 32, right_object="glass_sphere",
                        sphere_subdiv=TABLES[request.param])
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    return js, ts


def _unpacked(tg):
    """A treelet table rebuilt from `packed_triangles(tg)` alone: each
    treelet's rows in its first slots, zeros and the pad triangle id
    behind them."""
    rows, offsets = packed_triangles(tg)
    nt, _, k = tg.block.shape
    block = torch.zeros_like(tg.block)
    index = torch.full_like(tg.tri_index, int(tg.tri_index.max()))
    for j in range(nt):
        lo, hi = int(offsets[j]), int(offsets[j + 1])
        block[j, :, :hi - lo] = rows[lo:hi, :9].view(torch.float32).t()
        index[j, :hi - lo] = rows[lo:hi, 9]
    return TreeletGeom(tg.bmin, tg.bmax, index, block)


def test_packed_rows_hold_the_tables_triangles(scenes):
    """rows x offsets are the block's slots up to each treelet's count, in
    slot order, with tri_index in the tenth word; what lies past a count
    is all zero and indexes the pad triangle."""
    _, ts = scenes
    tg = ts.treelets
    rows, offsets = packed_triangles(tg)
    counts = triangle_counts(tg)
    nt, _, k = tg.block.shape
    assert rows.dtype == torch.int32 and rows.shape == (int(counts.sum()), 12)
    assert offsets.dtype == torch.int32 and offsets.shape == (nt + 1,)
    assert offsets[0] == 0
    assert torch.equal(offsets[1:] - offsets[:-1], counts)
    assert not rows[:, 10:].any()
    rebuilt = _unpacked(tg)
    assert torch.equal(rebuilt.block.view(torch.int32),
                       tg.block.view(torch.int32))
    assert torch.equal(rebuilt.tri_index, tg.tri_index)
    past = torch.arange(k)[None, :] >= counts[:, None]
    assert not tg.block.transpose(1, 2)[past].any()
    assert bool((tg.tri_index[past] == tg.tri_index.max()).all())


def test_pad_slots_never_hit(scenes):
    """An all-zero slot passes no ray's Moeller-Trumbore test, and the
    plain versions give the same result on the table and on the table
    with its trailing slots that no treelet fills cut off: the slots the
    kernels skip hold nothing a ray can hit."""
    _, ts = scenes
    tg = ts.treelets
    args = _torch(*_rays(21)[:4])
    ok, _, _, _ = moller_trumbore(torch.zeros((1, 9, 4)), args[0], args[1])
    assert not ok.any()
    # Keep at least one pad slot, so the cut differs from the table.
    kmax = min(int(triangle_counts(tg).max()), tg.block.shape[2] - 1)
    keep = torch.arange(tg.block.shape[2]) < kmax
    counts = triangle_counts(tg)
    full = counts > kmax  # a treelet that fills every slot stays whole
    block = torch.where(keep[None, None, :] | full[:, None, None], tg.block,
                        torch.zeros_like(tg.block))
    assert torch.equal(block, tg.block)
    cut = TreeletGeom(tg.bmin[~full], tg.bmax[~full],
                      tg.tri_index[~full][:, :kmax].contiguous(),
                      tg.block[~full][:, :, :kmax].contiguous())
    whole = TreeletGeom(*(x[~full].contiguous() for x in tg))
    for a, b in zip(closest_hit_plain(whole, *args),
                    closest_hit_plain(cut, *args)):
        assert torch.equal(a, b)
    segs = _torch(*_rays(22, live_frac=0.5, segment=True)[:4])
    occ = any_hit_plain(whole, *segs)
    assert torch.equal(occ, any_hit_plain(cut, *segs))
    assert 0 < int(occ.sum()) < segs[0].shape[0]


@pytest.mark.parametrize("order", ["reversed", "fewest_first", "shuffled"])
def test_any_hit_does_not_depend_on_the_treelet_order(scenes, order):
    _, ts = scenes
    tg = ts.treelets_any
    nt = tg.block.shape[0]
    perm = {"reversed": torch.arange(nt - 1, -1, -1),
            "fewest_first": torch.argsort(triangle_counts(tg), stable=True),
            "shuffled": torch.from_numpy(
                np.random.RandomState(5).permutation(nt))}[order]
    permuted = TreeletGeom(*(x[perm].contiguous() for x in tg))
    segs = _torch(*_rays(23, live_frac=0.5, segment=True)[:4])
    assert torch.equal(any_hit_plain(tg, *segs),
                       any_hit_plain(permuted, *segs))


def test_packed_offsets_of_empty_and_full_treelets(scenes):
    """The edge table of chip_smoke.py: 64 treelets, one with all K slots
    filled, most with none."""
    _, ts = scenes
    tg = ts.treelets
    k = tg.block.shape[2]
    edge = chip_smoke.edge_tables(tg, 64)
    one, limit = edge["one_treelet"], edge["limit_64"]
    assert one.block.shape[0] == 1
    assert packed_triangles(one)[1].tolist() == [0,
                                                 int(triangle_counts(tg)[5])]
    counts = triangle_counts(limit)
    rows, offsets = packed_triangles(limit)
    assert limit.block.shape[0] == 64
    assert int(counts[0]) == k and int(counts.min()) == 0
    assert int(offsets[-1]) == int(counts.sum()) == rows.shape[0]
    empty = torch.nonzero(counts == 0).squeeze(1)
    assert torch.equal(offsets[empty], offsets[empty + 1])
    rebuilt = _unpacked(limit)
    assert torch.equal(rebuilt.block.view(torch.int32),
                       limit.block.view(torch.int32))
    args = _torch(*_rays(24)[:4])
    got = closest_hit(limit, *args)
    assert int((got[1] >= 0).sum()) > 0
    for a, b in zip(got, closest_hit_plain(rebuilt, *args)):
        assert torch.equal(a, b)


def test_wrappers_match_the_reference_kernels(request, scenes):
    """closest_hit / any_hit (their plain versions on the CPU) against
    trace_closest_compact / trace_any_sweep in interpret mode, with the
    tolerances tests/test_torch_trace.py states."""
    js, ts = scenes
    table = request.node.callspec.params["scenes"]
    o, d, mn, mx, live = _rays(25)
    h = pallas_trace.trace_closest_compact(js.treelets, *_jax(o, d, mn, mx),
                                           interpret=True)
    got = closest_hit(ts.treelets, *_torch(o, d, mn, mx))
    assert (got[1] >= 0).sum() > o.shape[0] // 2
    _assert_closest_equal(*(np.asarray(x) for x in (h.t, h.tri, h.u, h.v)),
                          *(x.numpy() for x in got), live,
                          uv_atol=UV_ATOL[table])
    o, d, mn, mx, live = _rays(26, live_frac=0.3, segment=True)
    occ = pallas_sweep.trace_any_sweep(js.treelets_any, *_jax(o, d, mn, mx),
                                       interpret=True)
    got = any_hit(ts.treelets_any, *_torch(o, d, mn, mx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(occ))
    assert 0 < int(got.sum()) < int(live.sum())


def test_rng_key_defaults_to_the_card():
    """Read from the signature: there is no card here to allocate on."""
    assert inspect.signature(trng.key).parameters["device"].default == "cuda"
    k = trng.key((5 << 32) | 9, device="cpu")
    assert k.device.type == "cpu" and k.tolist() == [5, 9]


def test_render_image_on_a_cpu_scene():
    from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_image
    from bpt_tpu_torch.scene.procedural import cornell_box_scene

    scene, _, cam = cornell_box_scene(8, 8, device="cpu",
                                      right_object="glass_sphere")
    img, nrays = render_image(scene, cam, BDPTConfig(8, 8, spp=1, rr_depth=3),
                              seed=3)
    assert img.device.type == "cpu" and img.shape[:2] == (8, 8)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    assert int(nrays) > 0
