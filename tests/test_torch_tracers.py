"""The port's stackless BVH tracer (accel/traverse.py) and the plain
versions of K5 (full-table closest hit), K6 (tile-sweep closest hit) and
K7 (compact-table any hit) against the reference package: its
accel/traverse.py and its Pallas kernels trace_closest_pallas,
trace_closest_sweep and trace_any_compact, run as its own tests run them
on the CPU (interpret=True).  Inputs are tests/test_pallas.py's glass box
at subdiv 2 (7 treelets), B = 700 (tiles padded) and its three ray cases,
with every fifth lane dead; and constructed tables (ties, zero entries,
rays around the length of K5's lists)."""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.accel import api as japi
from bpt_tpu.accel import traverse as jtrav
from bpt_tpu.core.camera import generate_rays
from bpt_tpu.ops.pallas_sweep import trace_closest_sweep
from bpt_tpu.ops.pallas_trace import trace_any_compact, trace_closest_pallas
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.accel import api, traverse
from bpt_tpu_torch.accel.treelets import TreeletGeom
from bpt_tpu_torch.ops import trace_any as ta
from bpt_tpu_torch.ops import trace_closest as tc
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays
from test_torch_cuda import (_list_keys, _overflow_table, _tie_table,
                             _zero_entry_table)
from test_torch_trace import _assert_closest_equal

B = 700
CASES = ["camera", "inside", "window"]


@pytest.fixture(scope="module")
def scenes():
    js, _, cam = jax_cbox(32, 32, right_object="glass_sphere",
                          sphere_subdiv=2)
    ts = scene_from_arrays({k: np.asarray(v) for k, v in
                            flatten_fields(js)}, "cpu")
    return js, ts, cam


def _case(cam, name):
    """tests/test_pallas.py's three ray cases as (B,) numpy arrays, with
    every fifth lane dead (max_t = -1), and the live mask.

    The camera rays are jittered within their pixels: the pixel centres
    on the image diagonal aim exactly at the box's wall-ceiling edges,
    where XLA:CPU's contracted multiply-adds and the port's separately
    rounded ones decide the edge test differently (6 of the 700 lanes of
    the threaded-BVH walk, measured; see tests/test_torch_stream.py)."""
    cc = cam.device_constants()
    pix = jnp.arange(B, dtype=jnp.int32) % (32 * 32)
    rng = np.random.RandomState(3)
    if name == "camera":
        jitter = jnp.asarray(rng.rand(B, 2).astype(np.float32))
        o, d = (np.asarray(x) for x in generate_rays(cc, 32, 32, pix,
                                                      jitter))
        mn, mx = 1.0, 1000.0
    else:
        o = rng.uniform([-1, 0.1, -1], [1, 1.9, 1], (B, 3)).astype(np.float32)
        d = rng.normal(size=(B, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        mn, mx = (1e-8, 1e30) if name == "inside" else (0.5, 2.0)
    min_t = np.full(B, mn, np.float32)
    max_t = np.full(B, mx, np.float32)
    max_t[::5] = -1.0
    return o, d, min_t, max_t, max_t >= min_t


def _segments(js, cam):
    """test_sweep.py's shadow segments: camera-ray hit points to a point
    under the ceiling, every fifth lane dead."""
    cc = cam.device_constants()
    pix = jnp.arange(B, dtype=jnp.int32) % (32 * 32)
    o, d = generate_rays(cc, 32, 32, pix)
    hit = jtrav.trace_closest(js.geom, o, d, 1.0, 1000.0)
    p = np.asarray(o + d * jnp.where(jnp.isfinite(hit.t), hit.t,
                                     1.0)[:, None])
    seg = np.asarray([[0.0, 1.9, 0.0]], np.float32) - p
    dist = np.linalg.norm(seg, axis=-1)
    dn = (seg / dist[:, None]).astype(np.float32)
    max_t = (dist - 1e-5).astype(np.float32)
    max_t[::5] = -1.0
    return p, dn, np.full(B, 1e-8, np.float32), max_t


def _torch(*arrays):
    return [torch.from_numpy(np.array(a, order="C")) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _np(h):
    return [np.asarray(x) for x in h[:4]]


@pytest.mark.parametrize("case", CASES)
def test_traverse_matches_reference(scenes, case):
    """accel/traverse.py against the reference's, on the threaded BVH:
    closest hits under _assert_closest_equal's tolerances (XLA:CPU
    contracts multiply-adds, the port does not), occlusion flag for
    flag."""
    js, ts, cam = scenes
    o, d, mn, mx, live = _case(cam, case)
    ref = jtrav.trace_closest(js.geom, *_jax(o, d, mn, mx))
    got = traverse.trace_closest(ts.geom, *_torch(o, d, mn, mx))
    assert int(got.valid.sum()) > B // 4
    _assert_closest_equal(*_np(ref), *(x.numpy() for x in got[:4]), live)
    np.testing.assert_array_equal(got.valid.numpy(), got.tri.numpy() >= 0)
    occ_ref = jtrav.trace_any(js.geom, *_jax(o, d, mn, mx))
    occ = traverse.trace_any(ts.geom, *_torch(o, d, mn, mx))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))
    assert not occ.numpy()[~live].any()


def test_traverse_any_on_segments_and_scalar_windows(scenes):
    js, ts, cam = scenes
    o, d, mn, mx = _segments(js, cam)
    ref = np.asarray(jtrav.trace_any(js.geom, *_jax(o, d, mn, mx)))
    got = traverse.trace_any(ts.geom, *_torch(o, d, mn, mx)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < (mx >= mn).sum()
    # Scalar windows broadcast, as in the reference.
    h = traverse.trace_closest(ts.geom, *_torch(o, d), 1e-8, float("inf"))
    h2 = traverse.trace_closest(ts.geom, *_torch(o, d, np.full(B, 1e-8),
                                                 np.full(B, np.inf)))
    assert all(torch.equal(a, b) for a, b in zip(h, h2))


@pytest.mark.parametrize("case", CASES)
def test_full_plain_matches_pallas_full(scenes, case):
    """K5's plain version against trace_closest_pallas(interpret=True)
    under _assert_closest_equal's tolerances, and bit-equal to K1's
    plain version (the same function)."""
    js, ts, cam = scenes
    o, d, mn, mx, live = _case(cam, case)
    ref = trace_closest_pallas(js.treelets, *_jax(o, d, mn, mx),
                               interpret=True)
    got = tc.closest_hit_full_plain(ts.treelets, *_torch(o, d, mn, mx))
    _assert_closest_equal(*_np(ref), *(x.numpy() for x in got), live)
    k1 = tc.closest_hit_plain(ts.treelets, *_torch(o, d, mn, mx))
    for g, r in zip(got, k1):
        assert torch.equal(g, r)


@pytest.mark.parametrize("case", CASES)
def test_sweep_plain_matches_pallas_sweep(scenes, case):
    """K6's plain version against trace_closest_sweep(interpret=True) at
    tile 128 under _assert_closest_equal's tolerances; its t is K1's on
    every lane."""
    js, ts, cam = scenes
    o, d, mn, mx, live = _case(cam, case)
    ref = trace_closest_sweep(js.treelets, *_jax(o, d, mn, mx), tile=128,
                              interpret=True)
    got = tc.closest_hit_sweep_plain(ts.treelets, *_torch(o, d, mn, mx))
    _assert_closest_equal(*_np(ref), *(x.numpy() for x in got), live)
    k1 = tc.closest_hit_plain(ts.treelets, *_torch(o, d, mn, mx))
    assert torch.equal(got[0], k1[0])


def test_sweep_plain_is_the_same_in_groups_of_one_tile(scenes, monkeypatch):
    """The plain version takes tiles in groups bounded by SLAB_ELEMS; a
    bound of one tile per group gives the same hits, bit for bit."""
    _, ts, cam = scenes
    args = _torch(*_case(cam, "inside")[:4])
    ref = tc.closest_hit_sweep_plain(ts.treelets, *args)
    monkeypatch.setattr(tc, "SLAB_ELEMS", 1)
    got = tc.closest_hit_sweep_plain(ts.treelets, *args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("u,tile", [(128, 1024), (8, 512)])
def test_compact_any_plain_matches_pallas_compact(scenes, u, tile):
    """K7's plain version against trace_any_compact(interpret=True), flag
    for flag, and equal to K2's plain version."""
    js, ts, cam = scenes
    o, d, mn, mx = _segments(js, cam)
    ref = trace_any_compact(js.treelets_any, *_jax(o, d, mn, mx), tile=tile,
                            u=u, interpret=True)
    got = ta.any_hit_compact_plain(ts.treelets_any, *_torch(o, d, mn, mx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int((mx >= mn).sum())
    assert torch.equal(got, ta.any_hit_plain(ts.treelets_any,
                                             *_torch(o, d, mn, mx)))


WRAPPERS = [(tc.closest_hit_full, tc.closest_hit_full_plain),
            (tc.closest_hit_sweep, tc.closest_hit_sweep_plain),
            (ta.any_hit_compact, ta.any_hit_compact_plain)]
IDS = ["k5", "k6", "k7"]


@pytest.mark.parametrize("wrapper,plain", WRAPPERS, ids=IDS)
def test_wrappers_route_cpu_tensors_to_plain(scenes, wrapper, plain):
    _, ts, cam = scenes
    args = _torch(*_case(cam, "window")[:4])
    launches, calls = wrapper.launches, plain.cuda_calls
    got, ref = wrapper(ts.treelets, *args), plain(ts.treelets, *args)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(g, r)
    assert (wrapper.launches, plain.cuda_calls) == (launches, calls)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "table"])
@pytest.mark.parametrize("wrapper", [w for w, _ in WRAPPERS], ids=IDS)
def test_wrappers_reject_malformed_input(scenes, wrapper, bad):
    _, ts, cam = scenes
    o, d, mn, mx = _torch(*_case(cam, "inside")[:4])
    tg = ts.treelets
    if bad == "dtype":
        o = o.double()
    elif bad == "shape":
        mn = mn[:10]
    elif bad == "contiguous":
        d = torch.stack([d[:, 0], d[:, 1], d[:, 2]]).t()
    else:
        tg = tg._replace(tri_index=tg.tri_index[:, :-1].contiguous())
    with pytest.raises((TypeError, ValueError)):
        wrapper(tg, o, d, mn, mx)


@pytest.mark.parametrize("case", CASES)
def test_api_routes_a_scene_without_treelets_to_traverse(scenes, case,
                                                         monkeypatch):
    """A scene whose `treelets` is None goes to accel/traverse.py in both
    packages, without compaction and without a treelet kernel."""
    js, ts, cam = scenes
    o, d, mn, mx, live = _case(cam, case)
    js0, ts0 = js._replace(treelets=None), ts._replace(treelets=None)

    def refuse(*args):
        raise AssertionError("a treelet route was taken")

    for name in ("compact_rays", "closest_hit", "any_hit",
                 "closest_hit_stream", "any_hit_stream"):
        monkeypatch.setattr(api, name, refuse)
    ref = japi.trace_closest(js0, *_jax(o, d, mn, mx))
    got = api.trace_closest(ts0, *_torch(o, d, mn, mx))
    _assert_closest_equal(*_np(ref), *(x.numpy() for x in got[:4]), live)
    occ_ref = japi.trace_any(js0, *_jax(o, d, mn, mx))
    occ = api.trace_any(ts0, *_torch(o, d, mn, mx))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


class _Table(NamedTuple):
    bmin: object
    bmax: object
    tri_index: object
    block: object


def test_sweep_follows_the_tile_order_on_a_tie():
    """On an exact-t tie between treelets, K6 (port and reference) keeps
    the triangle of the treelet its tile visited first; K1 and K5 keep the
    one the lane itself reaches first."""
    table, rays = _tie_table()
    jtg, ttg = _Table(*_jax(*table)), TreeletGeom(*_torch(*table))
    ref = _np(trace_closest_sweep(jtg, *_jax(*rays), tile=128,
                                  interpret=True))
    got = [x.numpy() for x in tc.closest_hit_sweep_plain(ttg, *_torch(*rays))]
    lane = [x.numpy() for x in tc.closest_hit_plain(ttg, *_torch(*rays))]
    full = _np(trace_closest_pallas(jtg, *_jax(*rays), interpret=True))
    assert list(ref[1]) == list(got[1]) == [20, -1]
    assert list(lane[1]) == list(full[1]) == [10, -1]
    assert ref[0][0] == got[0][0] == lane[0][0] == full[0][0] == 5.0
    assert torch.equal(tc.closest_hit_full_plain(ttg, *_torch(*rays))[1],
                       torch.tensor([10, -1], dtype=torch.int32))


def test_sweep_and_full_on_zero_entries():
    """A lane whose entries to two treelets are both zero, one of them
    -0.0: K6's and K5's plain versions match the reference's
    trace_closest_sweep and trace_closest_pallas (interpret=True) and
    keep the lower-indexed treelet's triangle on the exact-t tie."""
    from bpt_tpu_torch.ops.intersect import slab

    table, rays = _zero_entry_table()
    jtg, ttg = _Table(*_jax(*table)), TreeletGeom(*_torch(*table))
    _, entry = slab(ttg.bmin, ttg.bmax, *_torch(*rays))
    assert entry[0].tolist() == [0.0, 0.0]
    assert torch.signbit(entry[0]).tolist() == [True, False]
    sweep = _np(trace_closest_sweep(jtg, *_jax(*rays), tile=128,
                                    interpret=True))
    full = _np(trace_closest_pallas(jtg, *_jax(*rays), interpret=True))
    for ref, plain in ((sweep, tc.closest_hit_sweep_plain),
                       (full, tc.closest_hit_full_plain)):
        got = [x.numpy() for x in plain(ttg, *_torch(*rays))]
        assert list(ref[1]) == list(got[1]) == [10, -1]
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[2], ref[2])
        np.testing.assert_array_equal(got[3], ref[3])
        assert got[0][0] == 1.0


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_full_plain_matches_pallas_full_at_the_list_length(delta):
    """The overflow table (_overflow_table) with rays that overlap C - 1,
    C and C + 1 treelets, C the keys a lane's list holds in K5, and rays
    that overlap all 40: K5's plain version against the reference's
    trace_closest_pallas (interpret=True), and each lane's hit the
    triangle it aims at."""
    from bpt_tpu_torch.ops.intersect import slab

    n = _list_keys() + delta
    table, rays, counts, tri = _overflow_table([n])
    jtg, ttg = _Table(*_jax(*table)), TreeletGeom(*_torch(*table))
    mask, _ = slab(ttg.bmin, ttg.bmax, *_torch(*rays))
    assert mask.sum(dim=1).tolist() == counts
    ref = _np(trace_closest_pallas(jtg, *_jax(*rays), interpret=True))
    got = [x.numpy() for x in tc.closest_hit_full_plain(ttg, *_torch(*rays))]
    _assert_closest_equal(*ref, *got, rays[3] >= rays[2])
    assert got[1].tolist() == ref[1].tolist() == tri
