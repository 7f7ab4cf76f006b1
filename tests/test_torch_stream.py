"""The large-scene path of the port on the CPU: the plain versions of K3
(closest hit on a table of any size) and K4 (any hit) against the
reference package's streaming Pallas kernels (interpret=True, as tests/
test_stream.py runs them) and against K1's and K2's plain versions, the
tables K3 and K4 derive (group boxes, triangle rows and counts), the
treelet-count routing of accel/api.py, a render through the streamed
route against the reference, and the scene-file entry (load_toml,
load_scene) against the reference's."""
from __future__ import annotations

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core.camera import generate_rays as jax_generate_rays
from bpt_tpu.integrators import bdpt as jb
from bpt_tpu.ops.pallas_sweep import trace_any_stream, trace_closest_stream
from bpt_tpu.scene.export import export_cornell_box as jax_export
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu.scene.scene import load_scene as jax_load_scene
from bpt_tpu.scene.toml_config import load_toml as jax_load_toml
from bpt_tpu_torch.accel import api
from bpt_tpu_torch.core import camera as tcam
from bpt_tpu_torch.integrators import bdpt as tb
from bpt_tpu_torch.ops import trace_any as ta
from bpt_tpu_torch.ops import trace_closest as tc
from bpt_tpu_torch.ops.intersect import MAX_TREELETS
from bpt_tpu_torch.scene.export import export_cornell_box
from bpt_tpu_torch.scene.procedural import cornell_box_scene as torch_cbox
from bpt_tpu_torch.scene.scene import (flatten_fields, load_scene,
                                       scene_from_arrays)
from bpt_tpu_torch.scene.toml_config import load_toml

CHUNKS = [3, 8, 64]


def _port_scene(js):
    return scene_from_arrays({k: np.asarray(v) for k, v in
                              flatten_fields(js)}, "cpu")


@pytest.fixture(scope="module")
def stream_scenes():
    """tests/test_stream.py's scene: the glass box at subdiv 2 (7
    treelets), in both packages."""
    js, _, jc = jax_cbox(32, 32, right_object="glass_sphere", sphere_subdiv=2)
    return js, jc, _port_scene(js)


def _stream_rays(jc, n=700, seed=5, dead_frac=0.3):
    """tests/test_stream.py's rays, but with jittered camera rays: half
    camera rays, half random rays from inside the box (window 2.0), 30%
    dead, not a tile multiple.

    Unjittered, the pixel-centre rays on the diagonal of the square image
    aim exactly at the box's wall-ceiling edges, where XLA:CPU's
    contracted multiply-adds and the port's separately rounded ones
    decide the edge test differently (2 of these 700 lanes, measured)."""
    cc = jc.device_constants()
    pix = jnp.arange(n, dtype=jnp.int32) % (32 * 32)
    rs = np.random.RandomState(seed)
    jitter = jnp.asarray(rs.rand(n, 2).astype(np.float32))
    o1, d1 = jax_generate_rays(cc, 32, 32, pix, jitter)
    o2 = rs.uniform([-1, 0.1, -1], [1, 1.9, 1], (n, 3)).astype(np.float32)
    d2 = rs.normal(size=(n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    coh = rs.rand(n) < 0.5
    o = np.where(coh[:, None], np.asarray(o1), o2).astype(np.float32)
    d = np.where(coh[:, None], np.asarray(d1), d2).astype(np.float32)
    mn = np.full(n, 1e-4, np.float32)
    live = rs.rand(n) >= dead_frac
    mx = np.where(live, np.where(coh, np.inf, 2.0), -1.0).astype(np.float32)
    return o, d, mn, mx


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("chunk_nt", CHUNKS)
def test_closest_stream_plain_matches_pallas_stream(stream_scenes, chunk_nt):
    """valid equal; t within rtol 1e-5 (XLA:CPU contracts multiply-adds
    in the interpret-mode kernel, the port rounds every operation, see
    tests/test_torch_trace.py); tri differs only where the two packages'
    t tie within 1e-6 relative, on at most 2% of the lanes."""
    js, jc, ts = stream_scenes
    o, d, mn, mx = _stream_rays(jc)
    h = trace_closest_stream(js.treelets, *(jnp.asarray(a) for a in
                                            (o, d, mn, mx)),
                             chunk_nt=chunk_nt, interpret=True)
    t, tri, _, _ = tc.closest_hit_stream_plain(ts.treelets,
                                               *_torch(o, d, mn, mx),
                                               chunk_nt)
    jt, jtri = np.asarray(h.t), np.asarray(h.tri)
    t, tri = t.numpy(), tri.numpy()
    valid = jtri >= 0
    np.testing.assert_array_equal(tri >= 0, valid)
    assert valid.sum() > 300
    np.testing.assert_allclose(t[valid], jt[valid], rtol=1e-5)
    mism = valid & (tri != jtri)
    assert np.all(np.abs(t[mism] - jt[mism]) <= 1e-6 * np.abs(jt[mism]))
    assert mism.mean() <= 0.02
    assert np.all(np.isinf(t[~valid]))


@pytest.mark.parametrize("chunk_nt", CHUNKS)
def test_any_stream_plain_matches_pallas_stream(stream_scenes, chunk_nt):
    js, jc, ts = stream_scenes
    o, d, mn, mx = _stream_rays(jc, seed=6)
    ref = trace_any_stream(js.treelets_any, *(jnp.asarray(a) for a in
                                              (o, d, mn, mx)),
                           chunk_nt=chunk_nt, interpret=True)
    got = ta.any_hit_stream_plain(ts.treelets_any, *_torch(o, d, mn, mx),
                                  chunk_nt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int((mx >= mn).sum())


@pytest.fixture(scope="module")
def subdiv5():
    """The glass box at subdiv 5: 20,504 triangles, 235 treelets, so
    groups of 8, 32 and 64 leave a ragged last group."""
    scene, meta, _ = torch_cbox(16, 16, device="cpu",
                                right_object="glass_sphere", sphere_subdiv=5)
    assert scene.treelets.block.shape[0] == 235
    return scene


def _box_rays(seed, n=3000, segment=False):
    rs = np.random.RandomState(seed)
    o = rs.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95],
                   (n, 3)).astype(np.float32)
    o[: n // 4] = [0.0, 1.0, 3.8]
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[: n // 4, 2] = -np.abs(d[: n // 4, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    live = rs.rand(n) < 0.7
    far = rs.uniform(0.1, 3.0, n).astype(np.float32) if segment else np.inf
    mx = np.where(live, far, -1.0).astype(np.float32)
    return _torch(o, d, np.full(n, 1e-8, np.float32), mx)


@pytest.mark.parametrize("chunk_nt", [8, 64, 235])
def test_streamed_plain_matches_unstreamed(subdiv5, chunk_nt):
    """K3's plain version at any group size is K1's plain version on
    every lane, t, tri, u and v alike (one visit order over the whole
    table); K4's flags are K2's."""
    tg = subdiv5.treelets
    args = _box_rays(11)
    ref = tc.closest_hit_plain(tg, *args)
    got = tc.closest_hit_stream_plain(tg, *args, chunk_nt)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int((ref[1] >= 0).sum()) > 1000
    seg = _box_rays(12, segment=True)
    occ = ta.any_hit_stream_plain(subdiv5.treelets_any, *seg, chunk_nt)
    assert torch.equal(occ, ta.any_hit_plain(subdiv5.treelets_any, *seg))
    assert 0 < int(occ.sum()) < int((seg[3] >= seg[2]).sum())


@pytest.mark.parametrize("g", [1, 8, 32])
def test_group_boxes_hold_their_members(subdiv5, g):
    """group_boxes: ceil(235 / g) union boxes, each the exact union of
    its members' boxes (so it contains them), built once per table and
    group size.  A ray that enters a member's box enters its group's box,
    which is what lets K3 and K4 skip a group's members."""
    from bpt_tpu_torch.accel.treelets import group_boxes

    tg = subdiv5.treelets
    gmin, gmax = group_boxes(tg, g)
    ng = -(-235 // g)
    assert gmin.shape == gmax.shape == (ng, 3)
    assert gmin.is_contiguous() and gmax.is_contiguous()
    member_group = torch.arange(235) // g
    assert bool((gmin[member_group] <= tg.bmin).all())
    assert bool((gmax[member_group] >= tg.bmax).all())
    for i in range(ng):
        torch.testing.assert_close(gmin[i], tg.bmin[i * g:(i + 1) * g].amin(0),
                                   rtol=0, atol=0)
        torch.testing.assert_close(gmax[i], tg.bmax[i * g:(i + 1) * g].amax(0),
                                   rtol=0, atol=0)
    again = group_boxes(tg, g)
    assert again[0] is gmin and again[1] is gmax
    from bpt_tpu_torch.ops.intersect import slab

    args = _box_rays(16)
    member, _ = slab(tg.bmin, tg.bmax, *args)
    group, _ = slab(gmin, gmax, *args)
    assert bool(member.any())
    assert not bool((member & ~group[:, member_group]).any())


def test_triangle_rows_hold_the_block(subdiv5):
    """triangle_rows: (NT, K, 12) rows, slot k of treelet j holding the
    block's (v0, e1, e2) column k and three zeros; triangle_counts: the
    slots before each treelet's pads, which are the slots whose triangle
    index is a real triangle's (the cut fills a treelet's first slots
    and pads the rest with the pad triangle T).  Both built once per
    table."""
    from bpt_tpu_torch.accel.treelets import triangle_counts, triangle_rows

    tg = subdiv5.treelets
    rows = triangle_rows(tg)
    nt, _, k = tg.block.shape
    assert rows.shape == (nt, k, 12) and rows.dtype == torch.float32
    assert rows.is_contiguous()
    assert torch.equal(rows[..., :9], tg.block.transpose(1, 2))
    assert not bool(rows[..., 9:].any())
    assert triangle_rows(tg) is rows
    counts = triangle_counts(tg)
    pad = int(tg.tri_index.max())
    assert counts.dtype == torch.int32 and counts.shape == (nt,)
    assert torch.equal(counts, (tg.tri_index < pad).sum(dim=1).int())
    assert 0 < int(counts.min()) and int(counts.max()) <= k
    slots = torch.arange(k)
    assert not bool(tg.block.transpose(1, 2)[slots >= counts[:, None]].any())
    assert triangle_counts(tg) is counts


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(api, name)

    def wrapped(*args):
        calls.append(args[-1] if name.endswith("stream") else None)
        return fn(*args)

    monkeypatch.setattr(api, name, wrapped)
    return calls


def test_api_routes_by_treelet_count(subdiv5, monkeypatch):
    args = _box_rays(13, n=600)
    seg = _box_rays(14, n=600, segment=True)
    base = api.trace_closest(subdiv5, *args), api.trace_any(subdiv5, *seg)
    names = ("closest_hit", "any_hit", "closest_hit_stream",
             "any_hit_stream")
    calls = {n: _counting(monkeypatch, n) for n in names}
    api.trace_closest(subdiv5, *args)
    api.trace_any(subdiv5, *seg)
    assert [len(calls[n]) for n in names] == [1, 1, 0, 0]

    monkeypatch.setattr(api, "MAX_TREELETS", 8)
    monkeypatch.setattr(api, "STREAM_CHUNK", 16)
    h = api.trace_closest(subdiv5, *args)
    occ = api.trace_any(subdiv5, *seg)
    assert [len(calls[n]) for n in names] == [1, 1, 1, 1]
    assert calls["closest_hit_stream"] == [16] == calls["any_hit_stream"]
    assert torch.equal(h.t, base[0].t) and torch.equal(h.valid, base[0].valid)
    assert torch.equal(occ, base[1])


def test_stream_wrappers_check_the_chunk(subdiv5):
    args = _box_rays(15, n=64)
    for chunk in (0, MAX_TREELETS + 1):
        with pytest.raises(ValueError):
            tc.closest_hit_stream(subdiv5.treelets, *args, chunk)
        with pytest.raises(ValueError):
            ta.any_hit_stream(subdiv5.treelets, *args, chunk)
    launches = tc.closest_hit_stream.launches, ta.any_hit_stream.launches
    got = tc.closest_hit_stream(subdiv5.treelets, *args, MAX_TREELETS)
    ref = tc.closest_hit_plain(subdiv5.treelets, *args)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (tc.closest_hit_stream.launches,
            ta.any_hit_stream.launches) == launches


def test_streamed_render_matches_reference(monkeypatch):
    """16x16, 2 spp, rr 3 with every trace on the streamed route (chunks
    of 8 over the 19 treelets) against the reference's render_image, on
    the aggregate gate of tests/test_torch_bdpt.py."""
    w = 16
    js, _, jc = jax_cbox(w, w, right_object="glass_sphere", sphere_subdiv=3)
    ts = _port_scene(js)
    tcm = tcam.Camera.make(jc.o, jc.at, jc.up, jc.fov, jc.width, jc.height)
    monkeypatch.setattr(api, "MAX_TREELETS", 8)
    monkeypatch.setattr(api, "STREAM_CHUNK", 8)
    calls = {n: _counting(monkeypatch, n) for n in ("closest_hit", "any_hit",
                                                    "closest_hit_stream",
                                                    "any_hit_stream")}
    ji, jn = jb.render_image(js, jc, jb.BDPTConfig(w, w, spp=2, rr_depth=3),
                             seed=1)
    ti, tn = tb.render_image(ts, tcm, tb.BDPTConfig(w, w, spp=2, rr_depth=3),
                             seed=1)
    assert not calls["closest_hit"] and not calls["any_hit"]
    assert calls["closest_hit_stream"] and calls["any_hit_stream"]
    a, b = ti.numpy(), np.asarray(ji)
    assert np.isfinite(a).all() and a.mean() > 0
    frac_off = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-3)
                      > 1e-3).mean())
    assert abs(tn - jn) / max(jn, 1) <= 1e-3, (tn, jn)
    assert abs(a.mean() - b.mean()) / max(b.mean(), 1e-9) <= 1e-3
    assert frac_off <= 0.02, frac_off


def test_load_toml_and_scene_match_reference(tmp_path):
    """The reference's exported glass box read by both packages: every
    scene leaf, the camera and the render settings equal."""
    toml_path = jax_export(str(tmp_path), width=40, height=30, spp=8,
                           rr_depth=4, right_object="glass_sphere",
                           sphere_subdiv=3)
    jcfg, tcfg = jax_load_toml(toml_path), load_toml(toml_path)
    for f in ("o", "at", "up"):
        np.testing.assert_array_equal(getattr(tcfg.camera, f),
                                      np.asarray(getattr(jcfg.camera, f)))
    for f in ("fov", "width", "height", "near", "far"):
        assert getattr(tcfg.camera, f) == getattr(jcfg.camera, f), f
    jd, td = vars(jcfg), vars(tcfg)
    assert jd.keys() == td.keys()
    for k in jd:
        if k != "camera":
            assert td[k] == jd[k], k
    assert (tcfg.width, tcfg.height, tcfg.spp, tcfg.rr_depth) == (40, 30, 8, 4)

    js, jmeta = jax_load_scene(jcfg.obj_file)
    ts, tmeta = load_scene(tcfg.obj_file, "cpu")
    j = {k: np.asarray(v) for k, v in flatten_fields(js)}
    t = {k: v.numpy() for k, v in flatten_fields(ts)}
    assert list(j) == list(t)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert tmeta.n_triangles == jmeta.n_triangles == 1304
    assert tmeta.shape_names == jmeta.shape_names


def test_export_writes_the_reference_files(tmp_path):
    kw = dict(width=48, height=32, spp=4, rr_depth=6,
              right_object="glass_sphere", sphere_subdiv=2)
    jax_export(str(tmp_path / "jax"), **kw)
    export_cornell_box(str(tmp_path / "port"), **kw)
    for name in ("cbox.obj", "cbox.mtl", "cbox.toml"):
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name
