"""Scene assembly of the port equals the reference package's leaf for
leaf, and the port runs with JAX absent."""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from bpt_tpu.scene import obj as jobj
from bpt_tpu.scene.procedural import cornell_box_scene as jax_cbox
from bpt_tpu_torch.scene.procedural import cornell_box_scene as torch_cbox
from bpt_tpu_torch.scene.scene import flatten_fields, scene_from_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = [
    dict(right_object="glass_sphere", sphere_subdiv=3),
    dict(right_object="mirror_sphere", left_object="mirror_box"),
    dict(),
]


def _assert_leaves_equal(jax_scene, torch_scene):
    j = {k: np.asarray(v) for k, v in flatten_fields(jax_scene)}
    t = {k: v.numpy() for k, v in flatten_fields(torch_scene)}
    assert list(j) == list(t)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("kw", SCENES, ids=["glass", "mirror", "plain"])
def test_build_scene_leaves_equal(kw):
    js, jmeta, _ = jax_cbox(32, 32, **kw)
    ts, tmeta, _ = torch_cbox(32, 32, device="cpu", **kw)
    _assert_leaves_equal(js, ts)
    assert tmeta.n_triangles == jmeta.n_triangles
    assert tmeta.bvh_nodes == jmeta.bvh_nodes
    assert tmeta.shape_names == jmeta.shape_names


def test_scene_from_arrays_round_trip():
    js, _, _ = jax_cbox(32, 32, right_object="glass_sphere", sphere_subdiv=3)
    arrays = {k: np.asarray(v) for k, v in flatten_fields(js)}
    ts = scene_from_arrays(arrays, "cpu")
    _assert_leaves_equal(js, ts)
    assert ts.treelets.block.shape == (19, 9, 128)


def test_port_runs_without_jax():
    """With `jax` unimportable, the port builds the glass box and renders
    8x8 at 1 spp on the CPU, and goes through a scene file (export,
    load_toml, load_scene), without loading any module of the JAX
    package."""
    code = textwrap.dedent("""
        import sys
        import tempfile
        sys.modules["jax"] = None
        import torch
        import bpt_tpu_torch
        from bpt_tpu_torch.scene.export import export_cornell_box
        from bpt_tpu_torch.scene.procedural import cornell_box_scene
        from bpt_tpu_torch.scene.scene import load_scene
        from bpt_tpu_torch.scene.toml_config import load_toml
        from bpt_tpu_torch.integrators.bdpt import BDPTConfig, render_image
        scene, _, cam = cornell_box_scene(
            8, 8, device="cpu", right_object="glass_sphere",
            sphere_subdiv=3)
        img, nrays = render_image(scene, cam, BDPTConfig(8, 8, spp=1,
                                                         rr_depth=3), seed=1)
        assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
        assert nrays > 0 and float(img.mean()) > 0.0
        with tempfile.TemporaryDirectory() as tmp:
            cfg = load_toml(export_cornell_box(tmp, 8, 8))
            _, meta = load_scene(cfg.obj_file, "cpu")
        assert meta.n_triangles > 0 and cfg.camera.width == 8
        leaked = [m for m in sys.modules
                  if m == "bpt_tpu" or m.startswith("bpt_tpu.")]
        assert not leaked, leaked
        print("OK", nrays)
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_scene_on_requested_device_and_dtypes():
    ts, _, _ = torch_cbox(16, 16, device="cpu", right_object="glass_sphere")
    for name, leaf in flatten_fields(ts):
        assert leaf.device == torch.device("cpu"), name
        assert leaf.dtype in (torch.float32, torch.int32), (name, leaf.dtype)
    assert ts.treelets_any is ts.treelets


def _textured_obj(tex_name):
    """A two-triangle quad with a texture-mapped material and a light."""
    mats = [jobj.Material(name="tex", diffuse=np.full(3, 0.5, np.float32),
                          illum=7, diffuse_texname=tex_name),
            jobj.Material(name="light", emission=np.full(3, 5.0, np.float32),
                          illum=7)]
    verts = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],
                      [-0.2, 1.9, -0.2], [0.2, 1.9, -0.2], [0.2, 1.9, 0.2]],
                     np.float32)
    tc = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    quad = np.array([[0, 1, 2], [0, 2, 3]])
    shapes = [
        jobj.Shape(name="floor", v_idx=quad, n_idx=np.full((2, 3), -1),
                   t_idx=quad, mat_ids=np.zeros(2, np.int64)),
        jobj.Shape(name="light", v_idx=np.array([[4, 5, 6]]),
                   n_idx=np.full((1, 3), -1), t_idx=np.full((1, 3), -1),
                   mat_ids=np.ones(1, np.int64)),
    ]
    return jobj.ObjData(vertices=verts, normals=np.zeros((0, 3), np.float32),
                        texcoords=tc, shapes=shapes, materials=mats)


def test_textured_scene_and_albedo_match(tmp_path):
    """build_scene's texture path (a PPM map_Kd) and albedo_at agree."""
    from bpt_tpu.scene.scene import build_scene as jax_build
    from bpt_tpu.scene.textures import albedo_at as jax_albedo
    from bpt_tpu_torch.scene.scene import build_scene as torch_build
    from bpt_tpu_torch.scene.textures import albedo_at as torch_albedo

    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    (tmp_path / "wood.ppm").write_bytes(b"P6\n7 5\n255\n" + img.tobytes())
    obj = _textured_obj("wood.ppm")
    js, _ = jax_build(obj, tex_dir=str(tmp_path))
    ts, _ = torch_build(obj, "cpu", tex_dir=str(tmp_path))
    _assert_leaves_equal(js, ts)
    assert ts.tex_atlas.shape == (1, 5, 7, 3)
    n = 512
    tri = rs.randint(0, 3, n).astype(np.int32)
    u = rs.rand(n).astype(np.float32) * 0.5
    v = rs.rand(n).astype(np.float32) * 0.5
    import jax.numpy as jnp

    ja = jax_albedo(js, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v))
    ta = torch_albedo(ts, *(torch.from_numpy(a) for a in (tri, u, v)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
