"""The port's native (C++) BVH builder: its source is the reference's,
byte for byte, and its trees equal the numpy builder's (its plain
version) and the reference's numpy builder's, as tests/test_native.py
holds the reference's native builder; without a compiler it raises."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from bpt_tpu.accel.build import build_bvh as ref_build_bvh
from bpt_tpu_torch.accel.build import build_bvh, build_bvh_numpy
from bpt_tpu_torch.native import native
from bpt_tpu_torch.scene.procedural import cornell_box

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("bmin", "bmax", "miss", "start", "count", "prim_order")


def _random_triangles(t):
    rng = np.random.RandomState(t)
    v0 = rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.5, 0.5, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _sphere_box_triangles():
    """The glass box with a subdiv-5 sphere: 20,504 triangles."""
    obj = cornell_box(right_object="glass_sphere", sphere_subdiv=5)
    v_idx = np.concatenate([s.v_idx for s in obj.shapes], axis=0)
    return tuple(obj.vertices[v_idx[:, c]] for c in range(3))


def _assert_equal_trees(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


@pytest.mark.parametrize("t", [1, 4, 5, 64, 1000, "subdiv5"])
def test_native_tree_equals_numpy_tree(t):
    """Bit-equal to the port's numpy builder and to the reference's numpy
    builder (the reference's own test allows rtol 1e-6 on the boxes; the
    port's flags keep them exact)."""
    tris = _sphere_box_triangles() if t == "subdiv5" else \
        _random_triangles(t)
    got = build_bvh(*tris)
    _assert_equal_trees(got, build_bvh_numpy(*tris))
    _assert_equal_trees(got, ref_build_bvh(*tris, use_native=False))
    assert got.bmin.dtype == np.float32 and got.miss.dtype == np.int32
    assert sorted(got.prim_order) == list(range(tris[0].shape[0]))


def test_empty_mesh_gives_an_empty_tree():
    tris = tuple(np.zeros((0, 3), np.float32) for _ in range(3))
    got = build_bvh(*tris)
    _assert_equal_trees(got, build_bvh_numpy(*tris))
    assert got.n_nodes == 0 and got.prim_order.shape == (0,)


def test_native_source_is_the_reference_copy():
    assert (REPO / "bpt_tpu_torch/native/bvh_builder.cpp").read_bytes() == \
        (REPO / "bpt_tpu/native/bvh_builder.cpp").read_bytes()


def test_vertex_arrays_of_another_shape_raise():
    v0, v1, v2 = _random_triangles(8)
    with pytest.raises(ValueError, match="T, 3"):
        build_bvh(v0, v1, v2[:5])


def test_without_a_compiler_the_build_raises(tmp_path, monkeypatch):
    """No g++ on PATH: a RuntimeError that says what is missing, and no
    numpy tree in its place."""
    monkeypatch.setattr(native, "_library", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        build_bvh(*_random_triangles(4))


def test_build_lands_under_a_hashed_name(tmp_path, monkeypatch):
    """A fresh build directory: one library named by the hash of source,
    flags and compiler, no temporary directory left behind, and a second
    load reuses it."""
    monkeypatch.setattr(native, "_library", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    tree = build_bvh(*_random_triangles(64))
    built = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert len(built) == 1 and built[0].startswith("libbpt_native_") \
        and built[0].endswith(".so")
    monkeypatch.setattr(native, "_library", None)
    _assert_equal_trees(build_bvh(*_random_triangles(64)), tree)
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == built
